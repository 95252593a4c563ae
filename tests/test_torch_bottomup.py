"""Port parity for the slice as a whole: bottom-up inference.

The JAX package's jitted ``BottomUpLayer`` and ``Predictor.predict`` run
beside the port's on the same frames and the same (converted) weights, on
the CPU; the port runs with ``fused_convs=True`` so its blocks go through
the fused-conv wrapper as on the card. Both sides group on their default
path, the C++ library.

As in ``test_torch_topdown.py``, frames are black with a few bright
Gaussian blobs and flax biases start at zero, so the maps are flat away
from the blobs and vary smoothly around them; the confmap head is scaled
and shifted so each channel spans [0, 1]. Tolerances: grouped peaks,
peak values and PAF scores to 1e-5 absolute (``-inf`` placement exact);
the same instances per frame, coordinates to 1e-5.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.inference import layers as jl
from sleap_nn_tpu.inference import paf_grouping as jpg
from sleap_nn_tpu.inference.backends import JaxBackend
from sleap_nn_tpu.inference.predictor import Predictor as JaxPredictor
from sleap_nn_tpu.inference.providers import VideoProvider as JaxVideoProvider
from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu_torch.config.model_config import UNetConfig
from sleap_nn_tpu_torch.inference import layers as tl
from sleap_nn_tpu_torch.inference import paf_grouping as tpg
from sleap_nn_tpu_torch.inference.backends import TorchBackend
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.inference.providers import VideoProvider
from sleap_nn_tpu_torch.models.heads import MultiInstanceConfmapsHead, PartAffinityFieldsHead
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

ns = types.SimpleNamespace
HW = 64
NAMES = ["n0", "n1", "n2", "n3"]
EDGES = [("n0", "n1"), ("n1", "n2"), ("n0", "n3")]
MIN_LINE = -0.5  # random PAFs: keep enough matches that instances form


class ArrayVideo:
    """In-memory video: any object with __len__ and get_frame(idx, fmt)."""

    def __init__(self, frames):
        self.frames = frames
        self.shape = frames.shape

    def __len__(self):
        return len(self.frames)

    def get_frame(self, idx, fmt=None):
        return self.frames[idx]


def blob_frames(n, seed=0, blobs=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:HW, :HW]
    out = np.zeros((n, HW, HW, 1), np.float32)
    for i in range(n):
        for _ in range(blobs):
            cy, cx = rng.uniform(10, HW - 10, 2)
            out[i, ..., 0] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 3.0**2))
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def _heads():
    return ns(confmaps=ns(part_names=NAMES, sigma=2.5, output_stride=2, loss_weight=None),
              pafs=ns(edges=[list(e) for e in EDGES], sigma=15.0, output_stride=4,
                      loss_weight=None))


def _model_pair(frames, seed=0):
    cfg = UNetConfig(in_channels=1, filters=4, filters_rate=1.5, max_stride=8, output_stride=2)
    fmodel = FlaxModel.from_config("unet", cfg, _heads(), "bottomup")
    params = fmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    head = params["params"]["MultiInstanceConfmapsHead"]["head_conv"]
    maps = np.asarray(fmodel.apply(params, jnp.asarray(frames / 255.0, jnp.float32))
                      ["MultiInstanceConfmapsHead"])
    top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
    # Per channel, the maps are moved onto [0, 1]: integral refinement then
    # divides by a patch mass well away from 0.
    head["kernel"] = (head["kernel"] / (top - bottom)).astype(np.float32)
    head["bias"] = (-bottom / (top - bottom)).astype(np.float32)
    tmodel = Model.from_config("unet", cfg, _heads(), "bottomup")
    return fmodel, params, tmodel, flax_to_torch_state(params, tmodel)


@pytest.fixture(scope="module")
def layers():
    frames = blob_frames(6)
    fmodel, params, tmodel, state = _model_pair(frames)
    pre = dict(ensure_grayscale=True, max_stride=8)
    post = dict(peak_threshold=0.2, max_peaks=40, max_instances=3, min_line_scores=MIN_LINE)
    scorer = dict(part_names=NAMES, edges=EDGES, pafs_stride=4, min_line_scores=MIN_LINE,
                  k_per_node=6)
    jlayer = jl.BottomUpLayer(JaxBackend(fmodel, params), jl.PreprocessConfig(**pre),
                              jl.PostprocessConfig(**post), paf_scorer=jpg.PAFScorer(**scorer),
                              cm_output_stride=2)
    tlayer = tl.BottomUpLayer(TorchBackend(tmodel, state, fused_convs=True, device="cpu"),
                              tl.PreprocessConfig(**pre), tl.PostprocessConfig(**post),
                              paf_scorer=tpg.PAFScorer(**scorer), cm_output_stride=2,
                              device="cpu")
    return frames, fmodel, params, tmodel, jlayer, tlayer


def test_bottomup_heads_and_weights_carry_across(layers):
    frames, fmodel, params, tmodel, _, _ = layers
    heads = tmodel.heads
    assert [type(h) for h in heads] == [MultiInstanceConfmapsHead, PartAffinityFieldsHead]
    assert heads[0].channels == 4 and heads[1].channels == 6
    assert heads[1].edges == tuple(tuple(e) for e in EDGES)
    assert {k for k in tmodel.state_dict() if k.startswith("head_layers")} == {
        "head_layers.0.MultiInstanceConfmapsHead.0.weight",
        "head_layers.0.MultiInstanceConfmapsHead.0.bias",
        "head_layers.1.PartAffinityFieldsHead.0.weight",
        "head_layers.1.PartAffinityFieldsHead.0.bias"}
    x = frames[:2] / np.float32(255.0)
    want = fmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        tmodel.load_state_dict(flax_to_torch_state(params, tmodel))
        got = tmodel(torch.from_numpy(x))
    for name, shape in [("MultiInstanceConfmapsHead", (2, 32, 32, 4)),
                        ("PartAffinityFieldsHead", (2, 16, 16, 6))]:
        assert tuple(got[name].shape) == shape
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]), rtol=0, atol=1e-5)


def _assert_device_outputs_match(got, want):
    for key in ("grouped_peaks", "grouped_vals", "scores"):
        g, w = got[key].numpy(), np.asarray(want[key])
        assert g.shape == w.shape and g.dtype == w.dtype, key
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w), err_msg=key)
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], rtol=0, atol=1e-5, err_msg=key)


def _assert_grouped_match(got, want):
    for key in ("pred_keypoints", "pred_peak_values", "pred_instance_scores"):
        assert len(got[key]) == len(want[key]), key
        for g, w in zip(got[key], want[key]):
            assert g.shape == w.shape and g.dtype == w.dtype, key
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=key)


def test_bottomup_layer_matches_jitted_jax(layers):
    frames, _, _, _, jlayer, tlayer = layers
    dev_want = jlayer.predict_async(frames[:4])
    dev_got = tlayer.predict_async(frames[:4])
    _assert_device_outputs_match(dev_got, dev_want)
    want, got = jlayer.finalize(dev_want), tlayer.finalize(dev_got)
    payload = tlayer.device_to_payload(dev_got)
    assert payload["lift"] == 1.0 and payload["scores"].shape == (4, 3, 6, 6)
    assert set(got) == set(want)
    _assert_grouped_match(got, want)
    # The comparison means something only if instances and links were found.
    assert sum(len(p) for p in want["pred_keypoints"]) >= 4
    assert np.isfinite(np.asarray(dev_want["scores"])).sum() > 20


@pytest.mark.parametrize("paf_workers", [0, 2])
def test_predictor_matches_jax_with_tail_batch(layers, paf_workers):
    frames, _, _, _, jlayer, tlayer = layers
    video = ArrayVideo(frames)  # 6 frames, batch 4: the tail batch is padded
    want = JaxPredictor(jlayer, "bottomup", None, [], batch_size=4).predict(
        video, provider=JaxVideoProvider(video, batch_size=4), make_labels=False)
    pred = Predictor(tlayer, "bottomup", batch_size=4, device="cpu", paf_workers=paf_workers)
    got = pred.predict(provider=VideoProvider(video, batch_size=4), make_labels=False)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert set(g) == set(w)
        _assert_grouped_match(g, w)
        for key in ("frame_inds", "video_inds", "valid"):
            np.testing.assert_array_equal(g[key], w[key])
    assert got[1]["valid"].tolist() == [True, True, False, False]
    assert pred.last_stats["n_frames"] == 6
