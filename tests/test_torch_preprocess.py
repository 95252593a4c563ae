"""Port parity: preprocessing (sleap_nn_tpu_torch.data + preprocess_images).

Same numpy frames through the JAX functions and the port on the CPU.
Tolerance 1e-6 on [0, 1] images (bilinear weights summed in another
order); shapes and ``eff_scale`` exactly. Shrinking resizes exercise
``jax.image.resize``'s antialiasing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.data import normalization as jnorm
from sleap_nn_tpu.data import resizing as jres
from sleap_nn_tpu.inference import layers as jlayers
from sleap_nn_tpu.inference.predictor import rgb_to_gray_uint8 as jax_gray
from sleap_nn_tpu_torch.data import normalization as tnorm
from sleap_nn_tpu_torch.data import resizing as tres
from sleap_nn_tpu_torch.inference import layers as tlayers
from sleap_nn_tpu_torch.inference.predictor import rgb_to_gray_uint8


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _close(got, want, atol=1e-6):
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0)


def test_normalize_and_channel_config():
    rgb = _frames((2, 9, 11, 3))
    gray = _frames((2, 9, 11, 1), seed=1)
    for img in (rgb, gray):
        x_j = jnorm.normalize_image(jnp.asarray(img))
        x_t = tnorm.normalize_image(torch.from_numpy(img))
        _close(x_t, x_j, atol=0)
        for flags in ((True, False), (False, True), (False, False)):
            _close(tnorm.apply_channel_config(x_t, *flags),
                   jnorm.apply_channel_config(x_j, *flags))


@pytest.mark.parametrize("scale", [0.5, 0.37, 1.5, 2.0])
def test_resize_image(scale):
    x = _frames((2, 20, 26, 1)).astype(np.float32) / 255.0
    _close(tres.resize_image(torch.from_numpy(x), scale),
           jres.resize_image(jnp.asarray(x), scale))


@pytest.mark.parametrize("max_hw", [(16, 16), (40, 30), (12, None), (None, 50)])
def test_sizematcher(max_hw):
    x = _frames((2, 20, 26, 3)).astype(np.float32) / 255.0
    got, eff_t = tres.apply_sizematcher(torch.from_numpy(x), *max_hw)
    want, eff_j = jres.apply_sizematcher(jnp.asarray(x), *max_hw)
    assert eff_t == eff_j
    _close(got, want)


@pytest.mark.parametrize("stride", [8, 16, 32])
def test_pad_to_stride(stride):
    x = _frames((1, 21, 35, 1)).astype(np.float32)
    _close(tres.apply_pad_to_stride(torch.from_numpy(x), stride),
           jres.apply_pad_to_stride(jnp.asarray(x), stride), atol=0)


def test_preprocess_images_full_chain():
    frames = _frames((2, 30, 41, 3), seed=2)
    kw = dict(ensure_grayscale=True, max_height=24, max_width=36, scale=0.5, max_stride=8)
    got, eff_t = tlayers.preprocess_images(tlayers.PreprocessConfig(**kw),
                                           torch.from_numpy(frames))
    want, eff_j = jlayers.preprocess_images(jlayers.PreprocessConfig(**kw), jnp.asarray(frames))
    assert eff_t == eff_j
    _close(got, want)


def test_rgb_to_gray_uint8_matches_jax_package():
    frames = _frames((3, 17, 19, 3), seed=3)
    np.testing.assert_array_equal(rgb_to_gray_uint8(frames), jax_gray(frames))
