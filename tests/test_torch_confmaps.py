"""Port parity: confidence-map rendering (``ops/confmaps.py`` and kernel 4's
plain version) against the JAX package's jnp path and its Pallas kernel in
interpret mode.

Inputs are numpy-made points with NaN instances and NaN nodes, on square
and non-square grids at strides 1, 2 and 4. Tolerance: 1e-6 absolute
(outputs are <= 1; ``exp`` of the same f32 arguments may differ by ulps).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.ops import confmaps as jcm
from sleap_nn_tpu.ops.grid import make_grid_vectors as jgrid
from sleap_nn_tpu.ops.pallas_kernels import make_multi_confmaps_pallas
from sleap_nn_tpu_torch.ops import confmaps as pcm
from sleap_nn_tpu_torch.ops.grid import make_grid_vectors as pgrid
from sleap_nn_tpu_torch.ops.kernels import MULTI_CONFMAPS, multi_confmaps

ATOL = 1e-6


def _points(shape, hw, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-5, max(hw) + 5, shape).astype(np.float32)
    pts[rng.random(shape[:-1]) < 0.25] = np.nan  # NaN nodes
    if len(shape) == 4:
        pts[0, -1] = np.nan  # a NaN (padding) instance
    return pts


def _close(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("hw,stride", [((32, 32), 1), ((48, 40), 2), ((24, 64), 4)])
def test_make_confmaps_matches(hw, stride):
    pts = _points((2, 4, 2), hw, seed=stride)
    jx, jy = jgrid(*hw, stride)
    px, py = pgrid(*hw, stride)
    _close(pcm.make_confmaps(torch.from_numpy(pts), px, py, 1.5 * stride),
           jcm.make_confmaps(jnp.asarray(pts), jx, jy, 1.5 * stride))


@pytest.mark.parametrize("hw,stride", [((32, 32), 1), ((48, 40), 2), ((24, 64), 4)])
@pytest.mark.parametrize("n_inst,n_nodes", [(1, 1), (5, 1), (4, 3)])
def test_make_multi_confmaps_matches_jnp_and_pallas(hw, stride, n_inst, n_nodes):
    pts = _points((3, n_inst, n_nodes, 2), hw, seed=n_inst * 10 + n_nodes)
    jx, jy = jgrid(*hw, stride)
    px, py = pgrid(*hw, stride)
    sigma = 2.5 * stride
    before = MULTI_CONFMAPS.launches
    got = pcm.make_multi_confmaps(torch.from_numpy(pts), px, py, sigma)
    assert MULTI_CONFMAPS.launches == before  # a CPU tensor takes the plain version
    _close(got, jcm.make_multi_confmaps(jnp.asarray(pts), jx, jy, sigma))
    _close(got, make_multi_confmaps_pallas(jnp.asarray(pts), jx, jy, sigma,
                                           interpret=True))


@pytest.mark.parametrize("shape", [(3, 2, 2), (2, 2, 3, 2, 2)])
def test_multi_confmaps_unbatched_points(shape):
    """Points with no batch axis, or more than one, are folded into one
    batch axis for kernel 4 and unfolded after."""
    pts = _points(shape, (20, 20), seed=4)
    jx, jy = jgrid(20, 20, 2)
    px, py = pgrid(20, 20, 2)
    _close(pcm.make_multi_confmaps(torch.from_numpy(pts), px, py, 3.0),
           jcm.make_multi_confmaps(jnp.asarray(pts), jx, jy, 3.0))


@pytest.mark.parametrize("is_centroids", [True, False])
@pytest.mark.parametrize("hw,stride", [((64, 64), 2), ((40, 56), 4), ((16, 24), 1)])
def test_generate_multiconfmaps_matches(is_centroids, hw, stride):
    shape = (2, 5, 2) if is_centroids else (2, 5, 3, 2)
    pts = _points(shape, hw, seed=stride + 7 * is_centroids)
    if is_centroids:
        pts[1, 3] = np.nan
    want = jcm.generate_multiconfmaps(jnp.asarray(pts), hw, sigma=5.0, output_stride=stride,
                                      is_centroids=is_centroids)
    got = pcm.generate_multiconfmaps(torch.from_numpy(pts), hw, sigma=5.0,
                                     output_stride=stride, is_centroids=is_centroids)
    _close(got, want)
    assert got.shape[-1] == (1 if is_centroids else 3)


def test_generate_confmaps_matches():
    pts = _points((2, 3, 2), (40, 40), seed=9)
    _close(pcm.generate_confmaps(torch.from_numpy(pts), (40, 40), sigma=2.0, output_stride=2),
           jcm.generate_confmaps(jnp.asarray(pts), (40, 40), sigma=2.0, output_stride=2))


def test_all_nan_instances_render_zero():
    pts = np.full((2, 3, 2, 2), np.nan, np.float32)
    px, py = pgrid(16, 16, 2)
    out = multi_confmaps(torch.from_numpy(pts), px, py, 2.0)
    assert out.shape == (2, 8, 8, 2) and (out == 0).all()


def test_multi_confmaps_checks_shapes():
    px, py = pgrid(16, 16, 2)
    with pytest.raises(ValueError, match="B, I, N, 2"):
        multi_confmaps(torch.zeros(2, 3, 3), px, py, 2.0)
    with pytest.raises(ValueError, match="1-D"):
        multi_confmaps(torch.zeros(1, 1, 1, 2), px[None], py, 2.0)
