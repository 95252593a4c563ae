"""Port parity for the slice as a whole: top-down inference.

The JAX package's ``TopDownLayer`` and ``Predictor.predict`` run beside
the port's on the same frames and the same (converted) weights, on the
CPU; the port runs with ``fused_convs=True`` so its blocks go through
the fused-conv wrapper as on the card.

Random-init confidence maps are near-flat, and a near-tie could flip an
argmax on float noise. This test gives the maps a clear peak structure
instead: frames are black with a few bright Gaussian blobs, and flax
initialises biases to zero, so away from the blobs every feature is
exactly 0 in both frameworks (ties there are exact, and both take the
first index); around the blobs the maps vary smoothly, far above float
noise. Head kernels are scaled so the maps reach about 1 and peaks clear
the threshold. Integer outputs (validity) must match exactly; peak
coordinates and values to 1e-4.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sleap_nn_tpu.inference.backends import JaxBackend
from sleap_nn_tpu.inference import layers as jl
from sleap_nn_tpu.inference.predictor import Predictor as JaxPredictor
from sleap_nn_tpu.inference.providers import VideoProvider as JaxVideoProvider
from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu_torch.config.model_config import UNetConfig
from sleap_nn_tpu_torch.inference import layers as tl
from sleap_nn_tpu_torch.inference.backends import TorchBackend
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.inference.providers import VideoProvider
from sleap_nn_tpu_torch.io.model import Skeleton
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

ns = types.SimpleNamespace
N_NODES, CROP, MAX_INST, HW = 3, 32, 3, 64


class ArrayVideo:
    """In-memory video: any object with __len__ and get_frame(idx, fmt)."""

    def __init__(self, frames):
        self.frames = frames
        self.shape = frames.shape

    def __len__(self):
        return len(self.frames)

    def get_frame(self, idx, fmt=None):
        return self.frames[idx]


def blob_frames(n, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:HW, :HW]
    out = np.zeros((n, HW, HW, 1), np.float32)
    for i in range(n):
        for _ in range(2):
            cy, cx = rng.uniform(12, HW - 12, 2)
            out[i, ..., 0] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 3.0**2))
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def _model_pair(model_type, frames, seed):
    cfg = UNetConfig(in_channels=1, filters=4, filters_rate=1.5, max_stride=8, output_stride=2)
    if model_type == "centroid":
        heads = ns(confmaps=ns(anchor_part=None, sigma=5.0, output_stride=2, loss_weight=None))
    else:
        heads = ns(confmaps=ns(part_names=[f"n{i}" for i in range(N_NODES)], anchor_part=None,
                               sigma=3.0, output_stride=2, loss_weight=None))
    fmodel = FlaxModel.from_config("unet", cfg, heads, model_type)
    params = fmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    head = next(k for k in params["params"] if k != "backbone")
    maps = np.asarray(fmodel.apply(params, jnp.asarray(frames / 255.0, jnp.float32))[head])
    kernel = params["params"][head]["head_conv"]["kernel"]
    top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
    # Per channel, the largest response maps to 1 (flipping the sign of a
    # channel whose blob responses are all negative).
    scale = np.where(top > 0, 1 / np.maximum(top, 1e-12), 1 / np.minimum(bottom, -1e-12))
    params["params"][head]["head_conv"]["kernel"] = (kernel * scale).astype(np.float32)
    tmodel = Model.from_config("unet", cfg, heads, model_type)
    return fmodel, params, tmodel, flax_to_torch_state(params, tmodel)


@pytest.fixture(scope="module")
def layers():
    frames = blob_frames(6)
    cm, cp, ctm, csd = _model_pair("centroid", frames, seed=0)
    im, ip, itm, isd = _model_pair("centered_instance", frames, seed=1)
    pre = dict(ensure_grayscale=True, max_stride=8)
    post = dict(peak_threshold=0.2, max_instances=MAX_INST)

    jlayer = jl.TopDownLayer(
        jl.CentroidLayer(JaxBackend(cm, cp), jl.PreprocessConfig(**pre),
                         jl.PostprocessConfig(**post), output_stride=2),
        jl.CenteredInstanceLayer(JaxBackend(im, ip), jl.PreprocessConfig(**pre),
                                 jl.PostprocessConfig(peak_threshold=0.2), output_stride=2),
        max_instances=MAX_INST, crop_size=CROP)
    dev = "cpu"
    tlayer = tl.TopDownLayer(
        tl.CentroidLayer(TorchBackend(ctm, csd, fused_convs=True, device=dev),
                         tl.PreprocessConfig(**pre), tl.PostprocessConfig(**post),
                         output_stride=2, device=dev),
        tl.CenteredInstanceLayer(TorchBackend(itm, isd, fused_convs=True, device=dev),
                                 tl.PreprocessConfig(**pre),
                                 tl.PostprocessConfig(peak_threshold=0.2),
                                 output_stride=2, device=dev),
        max_instances=MAX_INST, crop_size=CROP, device=dev)
    return frames, jlayer, tlayer


def _compare(got, want):
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w.astype(np.float32), atol=1e-4, rtol=0, err_msg=k)


def test_topdown_layer_matches_jax(layers):
    frames, jlayer, tlayer = layers
    want = jlayer.predict(frames[:4])
    got = tlayer.predict(frames[:4])
    _compare(got, want)
    # The comparison means something only if instances were found.
    assert want["instance_valid"].sum() >= 4
    kp = np.asarray(want["pred_keypoints"])
    assert np.isfinite(kp[want["instance_valid"]]).all()
    assert np.isnan(kp[~want["instance_valid"]]).all()


def test_predictor_matches_jax_with_tail_batch(layers):
    frames, jlayer, tlayer = layers
    video = ArrayVideo(frames[:6])  # 6 frames, batch 4: the tail batch is padded
    want = JaxPredictor(jlayer, "topdown", None, [], batch_size=4).predict(
        video, provider=JaxVideoProvider(video, batch_size=4), make_labels=False)
    pred = Predictor(tlayer, "topdown", None, [], batch_size=4, device="cpu")
    got = pred.predict(provider=VideoProvider(video, batch_size=4), make_labels=False)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _compare(g, w)
    assert got[1]["valid"].tolist() == [True, True, False, False]
    assert pred.last_stats["n_frames"] == 6
    # The duck-typed source also goes straight to predict().
    again = pred.predict(video, make_labels=False)
    for g, w in zip(again, got):
        _compare(g, w)


def test_predictor_refuses_labels_output(layers):
    """Labels output is ported for the top-down model: ``predict`` returns
    the instances of its raw outputs. A model type that no package has
    (every type of the JAX package is ported now) refuses it."""
    frames, _, tlayer = layers
    video = ArrayVideo(frames[:3])
    skeleton = Skeleton([f"n{i}" for i in range(N_NODES)])
    pred = Predictor(tlayer, "topdown", skeleton, device="cpu")
    raw = pred.predict(video, make_labels=False)[0]
    labels = pred.predict(video)
    want = [raw["pred_keypoints"][i][raw["instance_valid"][i]] for i in range(3)]
    assert [lf.frame_idx for lf in labels] == [i for i in range(3) if len(want[i])]
    for lf in labels:
        np.testing.assert_array_equal(np.stack([inst.points for inst in lf.instances]),
                                      want[lf.frame_idx])
    with pytest.raises(NotImplementedError, match="not ported"):
        Predictor(tlayer, "no_such_type", skeleton, device="cpu").predict(video)
