"""Port parity: confidence-map rendering (``ops/confmaps.py`` and kernel 4's
plain version) against the JAX package's jnp path and its Pallas kernel in
interpret mode.

Inputs are numpy-made points with NaN instances and NaN nodes, on square
and non-square grids at strides 1, 2 and 4. Tolerance: 1e-6 absolute
(outputs are <= 1; ``exp`` of the same f32 arguments may differ by ulps).
Kernel 4's cull is held against the jnp path exactly: every term it skips
renders 0 there.
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
from sleap_nn_tpu_torch.ops.kernels import (
    CONFMAP_CUTOFF,
    MULTI_CONFMAPS,
    _plain_multi_confmaps,
    confmap_cull_counts,
    confmap_live_points,
    confmap_tile,
    multi_confmaps,
)
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

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


@pytest.mark.parametrize("seed", range(6))
def test_terms_past_the_cull_cutoff_render_exact_zero(monkeypatch, seed):
    """Kernel 4 skips every term whose d^2 / denom is at or above
    ``CONFMAP_CUTOFF``. The JAX package's jnp path gives exactly 0 there
    (and so does the port's plain version), on a seeded grid of distances
    just past the cutoff and sigmas from tiny to large."""
    monkeypatch.setenv("SLEAP_NN_TPU_PALLAS", "0")
    rng = np.random.default_rng(seed)
    sigma = float(np.exp(rng.uniform(np.log(0.05), np.log(60.0))))
    denom = np.float32(2 * sigma**2)
    px, py = np.float32(rng.uniform(-50, 50, 2))
    reach = np.sqrt(np.float64(CONFMAP_CUTOFF) * denom)
    # Grid offsets from the point: 0 up to 1.2x the reach, dense near it.
    offsets = np.concatenate([np.linspace(0, 1.2, 48), 1 + rng.uniform(-0.02, 0.02, 48)]) * reach
    xv = (px + offsets * rng.choice([-1, 1], offsets.size)).astype(np.float32)
    yv = (py + rng.permutation(offsets)).astype(np.float32)
    pts = np.array([[[[px, py]]]], np.float32)  # (1, 1, 1, 2)
    ratio = ((xv[None, :] - px) ** 2 + (yv[:, None] - py) ** 2) / denom  # f32, (H, W)
    past = ratio >= np.float32(CONFMAP_CUTOFF)
    assert past.sum() > 100 and (~past).sum() > 100
    assert ratio[past].min() < CONFMAP_CUTOFF * 1.001  # terms right at the cutoff are included
    want = np.asarray(jcm.make_multi_confmaps(jnp.asarray(pts), jnp.asarray(xv), jnp.asarray(yv),
                                              sigma))[0, ..., 0]
    plain = _plain_multi_confmaps(torch.from_numpy(pts), torch.from_numpy(xv),
                                  torch.from_numpy(yv), sigma).numpy()[0, ..., 0]
    assert (want[past] == 0).all() and (plain[past] == 0).all()
    assert (want[ratio < 80] > 0).all()  # and the test reaches the nonzero side


@pytest.mark.parametrize("case", ["uniform", "far", "tiny_sigma", "huge_sigma", "shuffled_xv",
                                  "descending_xv", "ragged_15_nodes"])
def test_cull_drops_only_points_whose_terms_are_zero(monkeypatch, case):
    """Kernel 4's cull rule, mirrored on the host by ``confmap_live_points``:
    every point it drops from a tile renders exactly 0 over that tile in the
    JAX package's jnp path, one instance at a time."""
    monkeypatch.setenv("SLEAP_NN_TPU_PALLAS", "0")
    rng = np.random.default_rng(len(case))
    n_nodes = 15 if case == "ragged_15_nodes" else 2
    h, w = (19, 51) if case == "ragged_15_nodes" else (70, 45)
    sigma = {"tiny_sigma": 1e-3, "huge_sigma": 1e4}.get(case, 2.5)
    xv, yv = (a.numpy() for a in pgrid(2 * h, 2 * w, 2))
    xv, yv = xv[:w].copy(), yv[:h].copy()
    if case == "shuffled_xv":
        xv, yv = rng.permutation(xv), rng.permutation(yv)
    if case == "descending_xv":
        xv = xv[::-1].copy()
    pts = rng.uniform(-10, 2 * max(h, w) + 10, (2, 4, n_nodes, 2)).astype(np.float32)
    pts[rng.random((2, 4, n_nodes)) < 0.2] = np.nan
    if case == "far":
        pts[:, :2] += np.float32(5000.0)
        pts[1, 2, 0] = [np.inf, 3.0]  # a non-finite bound keeps the point
    live = confmap_live_points(torch.from_numpy(pts), torch.from_numpy(xv),
                               torch.from_numpy(yv), sigma).numpy()
    th, tw = confmap_tile(n_nodes)
    assert live.shape == (2, -(-h // th), -(-w // tw), 4, n_nodes)
    assert 0 < live.sum() < live.size
    terms = np.asarray(jcm.make_confmaps(jnp.asarray(pts), jnp.asarray(xv), jnp.asarray(yv),
                                         sigma))  # (B, I, H, W, N)
    for b, ty, tx, i, n in zip(*np.nonzero(~live)):
        assert (terms[b, i, ty * th:(ty + 1) * th, tx * tw:(tx + 1) * tw, n] == 0).all()
    if case == "far":
        assert live[1, :, :, 2, 0].all()


@pytest.mark.parametrize("case", ["huge_sigma", "all_nan"])
def test_cull_counts_at_their_ends(case):
    """``confmap_cull_counts`` (the host model the card holds kernel 4's own
    counts to): every point live over the whole grid, or none."""
    pts = _points((2, 3, 2, 2), (70, 50), seed=5)
    if case == "all_nan":
        pts[:] = np.nan
    xv, yv = pgrid(100, 70, 2)  # 50 rows x 35 columns: 2 x 2 tiles of 32 x 32
    tiles, terms, n_tiles = confmap_cull_counts(torch.from_numpy(pts), xv, yv,
                                                1e4 if case == "huge_sigma" else 2.0)
    assert n_tiles == 2 * 2 * 2
    valid = int(np.isfinite(pts).all(axis=-1).sum())
    assert (tiles, terms) == ((8, valid * 50 * 35) if case == "huge_sigma" else (0, 0))


@pytest.mark.parametrize("n_nodes", [1, 2, 15, 16, 100, 300, 5000])
def test_confmap_tile_fits_the_kernel(n_nodes):
    th, tw = confmap_tile(n_nodes)
    assert 1 <= th <= 32 and 1 <= tw <= 32 and tw & (tw - 1) == 0
    assert th * tw * n_nodes <= max(4096, n_nodes)
    assert (th, tw) == {1: (32, 32), 15: (8, 32)}.get(n_nodes, (th, tw))
