"""Port parity: ``data/instance_cropping.py`` against the JAX package.

The crop-size helpers must give exactly the JAX package's ints (rotation
and scale padding, ``min_crop_size``, stride rounding) on the same labels;
``generate_crops`` exactly the same crops, shifted instances and shifted
centroids on the same f32 inputs, near the borders and with NaN
centroids (the shift is the truncated top-left that the gather starts at).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.data import instance_cropping as jic
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu_torch.data import instance_cropping as pic
from sleap_nn_tpu_torch.io import model as pio
from tests.test_torch_pipeline import make_labels
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)


@pytest.mark.parametrize("bbox,rot,scale", [
    (40.0, 0.0, 1.0), (40.0, 15.0, 1.0), (37.5, -30.0, 1.2), (80.0, 45.0, 0.9),
    (80.0, 180.0, 1.1), (13.0, 0.0, 1.3)])
def test_compute_augmentation_padding_matches(bbox, rot, scale):
    assert pic.compute_augmentation_padding(bbox, rot, scale) == \
        jic.compute_augmentation_padding(bbox, rot, scale)


@pytest.mark.parametrize("padding,stride,min_crop", [
    (0, 2, None), (0, 8, 100), (7, 16, 0), (0, 32, 96), (3, 32, 100), (50, 4, 10)])
def test_find_instance_crop_size_matches(padding, stride, min_crop):
    jl, pl = make_labels(jio, seed=3), make_labels(pio, seed=3)
    assert pic.find_max_instance_bbox_size(pl) == jic.find_max_instance_bbox_size(jl) > 0
    got = pic.find_instance_crop_size(pl, padding=padding, maximum_stride=stride,
                                      min_crop_size=min_crop)
    want = jic.find_instance_crop_size(jl, padding=padding, maximum_stride=stride,
                                       min_crop_size=min_crop)
    assert type(got) is type(want) is int and got == want and got % stride == 0


@pytest.mark.parametrize("crop", [16, 17, 32])
def test_generate_crops_matches(crop):
    rng = np.random.default_rng(crop)
    b, h, w = 7, 40, 52
    image = rng.random((b, h, w, 2), dtype=np.float32)
    cents = rng.uniform(0, 52, (b, 2)).astype(np.float32)
    cents[0] = [0.3, 39.6]  # near the borders: the crop leaves the image
    cents[1] = [51.5, -2.25]
    cents[2] = [-30.0, 70.0]  # far outside
    cents[3] = np.nan  # a NaN centroid: an all-zero crop, NaN shifts
    cents[4] = [20.5, 19.5]  # a half-pixel center, where trunc and floor part
    inst = rng.uniform(-5, 55, (b, 5, 2)).astype(np.float32)
    inst[5, 1] = np.nan
    want = jic.generate_crops(jnp.asarray(image), jnp.asarray(inst), jnp.asarray(cents), crop)
    got = pic.generate_crops(torch.from_numpy(image), torch.from_numpy(inst),
                             torch.from_numpy(cents), crop)
    for name, g, wnt in zip(("crops", "instances", "centroids"), got, want):
        wnt = np.asarray(wnt)
        assert g.shape == wnt.shape and g.dtype == torch.float32, name
        np.testing.assert_array_equal(g.numpy(), wnt, err_msg=name)
    assert (got[0][3] == 0).all() and torch.isnan(got[1][3]).all()
    assert got[0][4].abs().sum() > 0
