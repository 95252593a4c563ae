"""Port parity: ``ops/edge_maps.py`` (part-affinity-field targets) against the
JAX package.

Every function runs in both packages on the same numpy-made inputs, on the
CPU. Cases: NaN instances and nodes, a zero-length edge, an instance
outside the image, coordinates at the strict image bounds, both channel
layouts, and a batch (the JAX package's ``vmap`` against the port's
broadcast). Tolerance 1e-6 absolute: the maps are at most a few in
magnitude and both sides compute the same f32 expressions (``exp`` may
differ by an ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.ops import edge_maps as jem
from sleap_nn_tpu_torch.ops import edge_maps as pem
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

ATOL = 1e-6


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _close(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _instances(seed, shape, hw, nan_frac=0.2):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5, max(hw) + 5, (*shape, 2)).astype(np.float32)
    pts[rng.random(shape) < nan_frac] = np.nan
    return pts


def _edges(n_nodes):
    return np.array([(i, i + 1) for i in range(n_nodes - 1)] + [(0, n_nodes - 1)], np.int32)


def test_distance_to_edge_matches():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-10, 50, (7, 9, 2)).astype(np.float32)
    src = rng.uniform(0, 40, (5, 2)).astype(np.float32)
    dst = rng.uniform(0, 40, (5, 2)).astype(np.float32)
    dst[1] = src[1]  # a zero-length edge: the squared length clamps to 1
    dst[2] = src[2] + np.float32(0.25)  # shorter than 1
    want = jem.distance_to_edge(jnp.asarray(pts), jnp.asarray(src), jnp.asarray(dst))
    got = pem.distance_to_edge(_t(pts), _t(src), _t(dst))
    assert got.shape == (7, 9, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)


@pytest.mark.parametrize("fn", ["make_edge_maps", "make_pafs"])
def test_single_edge_set_maps_match(fn):
    rng = np.random.default_rng(1)
    xv = np.arange(0, 40, 2, dtype=np.float32)
    yv = np.arange(0, 30, 2, dtype=np.float32)
    src = rng.uniform(0, 40, (4, 2)).astype(np.float32)
    dst = rng.uniform(0, 40, (4, 2)).astype(np.float32)
    dst[3] = src[3]  # zero length: make_pafs gives NaN, as the JAX package does
    src[2, 1] = np.nan
    args = (xv, yv, src, dst, 6.0)
    _close(getattr(pem, fn)(*map(_t, args[:4]), 6.0),
           getattr(jem, fn)(*map(jnp.asarray, args[:4]), 6.0))


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_make_multi_pafs_matches(lead):
    rng = np.random.default_rng(len(lead))
    xv = np.arange(0, 48, 4, dtype=np.float32)
    yv = np.arange(0, 36, 4, dtype=np.float32)
    src = rng.uniform(-4, 50, (*lead, 3, 4, 2)).astype(np.float32)
    dst = rng.uniform(-4, 50, (*lead, 3, 4, 2)).astype(np.float32)
    src[..., 1, :, :] = np.nan  # a padding instance
    dst[..., 0, 2, :] = src[..., 0, 2, :]  # a zero-length edge
    src[..., 2, 1, 0] = np.nan
    want = jem.make_multi_pafs(jnp.asarray(xv), jnp.asarray(yv), jnp.asarray(src),
                               jnp.asarray(dst), 8.0)
    got = pem.make_multi_pafs(_t(xv), _t(yv), _t(src), _t(dst), 8.0)
    assert got.shape == (*lead, 9, 12, 4, 2)
    _close(got, want)
    assert np.abs(np.asarray(want)).max() > 0.5  # the maps are not empty


def test_get_edge_points_matches():
    pts = _instances(2, (2, 3, 5), (40, 40))
    edges = _edges(5)
    want = jem.get_edge_points(jnp.asarray(pts), jnp.asarray(edges))
    got = pem.get_edge_points(_t(pts), _t(edges))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("flatten", [True, False])
@pytest.mark.parametrize("stride,sigma", [(2, 1.5), (4, 15.0), (1, 3.0)])
def test_generate_pafs_matches(stride, sigma, flatten):
    hw = (48, 40)
    pts = _instances(stride, (4, 5), hw)
    pts[1] = np.nan  # a padding instance
    pts[2] = [[-3.0, 10.0], [60.0, 5.0], [20.0, -1.0], [50.0, 70.0], [np.nan, 7.0]]  # outside
    pts[3, 2] = pts[3, 1]  # a zero-length edge (1 -> 2)
    # On the strict bounds: x = 0 or x = xv[-1] is outside.
    pts[0, 0] = [0.0, 12.0]
    pts[0, 4] = [hw[1] - stride, 12.0]
    edges = _edges(5)
    want = jem.generate_pafs(jnp.asarray(pts), hw, jnp.asarray(edges), sigma=sigma,
                             output_stride=stride, flatten_channels=flatten)
    got = pem.generate_pafs(_t(pts), hw, [tuple(e) for e in edges.tolist()], sigma=sigma,
                            output_stride=stride, flatten_channels=flatten)
    shape = (hw[0] // stride, hw[1] // stride)
    assert got.shape == ((*shape, 2 * len(edges)) if flatten else (*shape, len(edges), 2))
    _close(got, want)
    assert np.abs(np.asarray(want)).max() > 0.5


def test_generate_pafs_batch_matches_vmap():
    """The port renders a batch at once; the JAX pipeline vmaps per sample."""
    hw = (64, 64)
    pts = _instances(7, (3, 6, 5), hw)
    pts[0, 3:] = np.nan
    pts[2, 1] = [[-5.0, -5.0]] * 5  # every node outside: the instance renders 0
    edges = _edges(5)
    want = jax.vmap(lambda inst: jem.generate_pafs(inst, hw, jnp.asarray(edges), sigma=15.0,
                                                    output_stride=4))(jnp.asarray(pts))
    got = pem.generate_pafs(_t(pts), hw, _t(edges), sigma=15.0, output_stride=4)
    assert got.shape == (3, 16, 16, 10)
    _close(got, want)
    # The instance with no node inside renders nothing: without it, the same maps.
    alone = pts.copy()
    alone[2, 1] = np.nan
    torch.testing.assert_close(pem.generate_pafs(_t(alone), hw, _t(edges), sigma=15.0,
                                                 output_stride=4), got, rtol=0, atol=0)
