"""Port parity: single-instance inference (``SingleInstanceLayer`` and
``Predictor.predict``) against the JAX package.

As in ``tests/test_torch_topdown.py``: frames are black with a few bright
Gaussian blobs, so away from the blobs every feature is exactly 0 in both
frameworks, and the head kernels are scaled so the maps reach about 1. One
frame is all black: its maps are exactly 0, below the threshold in both
packages, so every keypoint of it must be NaN in both. The port runs with
``fused_convs=True`` so its blocks go through the fused-conv wrapper as
on the card. Maps to 1e-4, keypoints to 1e-4 px (the lift by
``output_stride / (scale * eff_scale)`` included), NaN placement exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sleap_nn_tpu.inference import layers as jl
from sleap_nn_tpu.inference.backends import JaxBackend
from sleap_nn_tpu.inference.predictor import Predictor as JaxPredictor
from sleap_nn_tpu.inference.providers import VideoProvider as JaxVideoProvider
from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu_torch.config.model_config import UNetConfig
from sleap_nn_tpu_torch.inference import layers as tl
from sleap_nn_tpu_torch.inference.backends import TorchBackend
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.inference.providers import VideoProvider
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_topdown import HW, ArrayVideo, blob_frames, ns

N_NODES = 4


def _frames():
    frames = blob_frames(7, seed=3)
    frames[2] = 0  # all black: no peak clears the threshold
    return frames


@pytest.fixture(scope="module")
def model_pair():
    frames = _frames()
    cfg = UNetConfig(in_channels=1, filters=4, filters_rate=1.5, max_stride=8, output_stride=2)
    heads = ns(confmaps=ns(part_names=[f"n{i}" for i in range(N_NODES)], sigma=2.5,
                           output_stride=2, loss_weight=None))
    fmodel = FlaxModel.from_config("unet", cfg, heads, "single_instance")
    params = fmodel.init(jax.random.PRNGKey(4), jnp.zeros((1, HW, HW, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    head = params["params"]["SingleInstanceConfmapsHead"]["head_conv"]
    maps = np.asarray(fmodel.apply(params, jnp.asarray(frames / 255.0, jnp.float32))[
        "SingleInstanceConfmapsHead"])
    top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
    scale = np.where(top > 0, 1 / np.maximum(top, 1e-12), 1 / np.minimum(bottom, -1e-12))
    head["kernel"] = (head["kernel"] * scale).astype(np.float32)
    tmodel = Model.from_config("unet", cfg, heads, "single_instance")
    return frames, fmodel, params, tmodel, flax_to_torch_state(params, tmodel)


def _layers(model_pair, scale=1.0, return_confmaps=False):
    _, fmodel, params, tmodel, sd = model_pair
    pre = dict(ensure_grayscale=True, max_stride=8, scale=scale)
    post = dict(peak_threshold=0.2, return_confmaps=return_confmaps)
    jlayer = jl.SingleInstanceLayer(JaxBackend(fmodel, params), jl.PreprocessConfig(**pre),
                                    jl.PostprocessConfig(**post), output_stride=2)
    tlayer = tl.SingleInstanceLayer(TorchBackend(tmodel, sd, fused_convs=True, device="cpu"),
                                    tl.PreprocessConfig(**pre), tl.PostprocessConfig(**post),
                                    output_stride=2, device="cpu")
    return jlayer, tlayer


def _compare(got, want):
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
            np.testing.assert_allclose(g, w.astype(np.float32), atol=1e-4, rtol=0, err_msg=k)


@pytest.mark.parametrize("scale,return_confmaps", [(1.0, True), (0.5, False)])
def test_single_instance_layer_matches_jax(model_pair, scale, return_confmaps):
    frames = model_pair[0]
    jlayer, tlayer = _layers(model_pair, scale, return_confmaps)
    want = jlayer.predict(frames[:4])
    got = tlayer.predict(frames[:4])
    _compare(got, want)
    kp = np.asarray(want["pred_keypoints"])
    assert kp.shape == (4, 1, N_NODES, 2) and want["pred_peak_values"].shape == (4, 1, N_NODES)
    # The black frame finds nothing; the blob frames find every node.
    assert np.isnan(kp[2]).all() and (np.asarray(want["pred_peak_values"])[2] == 0).all()
    assert np.isfinite(kp[[0, 1, 3]]).all()
    assert ("confmaps" in got) == return_confmaps


def test_predictor_matches_jax_with_tail_batch(model_pair):
    frames = model_pair[0]
    jlayer, tlayer = _layers(model_pair)
    video = ArrayVideo(frames)  # 7 frames, batch 4: the tail batch is padded
    want = JaxPredictor(jlayer, "single_instance", None, [], batch_size=4).predict(
        video, provider=JaxVideoProvider(video, batch_size=4), make_labels=False)
    pred = Predictor(tlayer, "single_instance", None, [], batch_size=4, device="cpu")
    got = pred.predict(provider=VideoProvider(video, batch_size=4), make_labels=False)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        _compare(g, w)
    assert got[1]["valid"].tolist() == [True, True, True, False]
    assert pred.last_stats["n_frames"] == 7
