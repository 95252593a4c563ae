"""Port parity: peaks and crops (sleap_nn_tpu_torch.ops.peaks / .crops).

Same numpy inputs through the JAX functions and the port on the CPU.
Integer outputs (peak positions, channels, validity, crop pixels) must
match exactly, including the ``lax.top_k`` tie order and the
``lax.dynamic_slice`` start clamp; refined floats to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.ops import crops as jcrops
from sleap_nn_tpu.ops import peaks as jpeaks
from sleap_nn_tpu_torch.ops import crops as tcrops
from sleap_nn_tpu_torch.ops import peaks as tpeaks
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)


def _assert_same(got, want, atol=0.0):
    got = [g.numpy() for g in got]
    want = [np.asarray(w) for w in want]
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, atol=atol, rtol=0)
        else:
            np.testing.assert_array_equal(g, w)


def _tied_maps(seed):
    """Isolated single-pixel peaks sharing a few values, so top-K must
    break ties by flat index (lower first)."""
    rng = np.random.default_rng(seed)
    cms = np.zeros((2, 16, 20, 2), np.float32)
    for b in range(2):
        for _ in range(12):
            y, x, c = rng.integers(1, 15), rng.integers(1, 19), rng.integers(0, 2)
            if cms[b, y - 1:y + 2, x - 1:x + 2, c].max() == 0:
                cms[b, y, x, c] = rng.choice([0.5, 0.75, 0.9])
    return cms


@pytest.mark.parametrize("refinement", [None, "integral"])
@pytest.mark.parametrize("max_peaks", [5, 30, 1000])
def test_find_local_peaks_tied_maxima(refinement, max_peaks):
    cms = _tied_maps(seed=max_peaks)
    want = jpeaks.find_local_peaks(jnp.asarray(cms), threshold=0.2, refinement=refinement,
                                   max_peaks=max_peaks, return_rough=True)
    got = tpeaks.find_local_peaks(torch.from_numpy(cms), threshold=0.2, refinement=refinement,
                                  max_peaks=max_peaks, return_rough=True)
    _assert_same(got, want, atol=1e-5)


def test_find_local_peaks_random_maps():
    cms = np.random.default_rng(1).random((3, 12, 14, 3), dtype=np.float32)
    want = jpeaks.find_local_peaks(jnp.asarray(cms), threshold=0.3, refinement="integral",
                                   max_peaks=20)
    got = tpeaks.find_local_peaks(torch.from_numpy(cms), threshold=0.3, refinement="integral",
                                  max_peaks=20)
    _assert_same(got, want, atol=1e-5)


def test_top_k_ties_lower_index_first():
    scores = torch.tensor([[0.5, 1.0, 0.5, 1.0, float("-inf"), 0.5]])
    vals, idx = tpeaks.top_k(scores, 4)
    assert idx.tolist() == [[1, 3, 0, 2]]
    assert vals.tolist() == [[1.0, 1.0, 0.5, 0.5]]


@pytest.mark.parametrize("refinement", [None, "integral"])
def test_find_global_peaks(refinement):
    rng = np.random.default_rng(2)
    cms = rng.random((4, 11, 13, 3), dtype=np.float32) * 0.6
    cms[0, :, :, 0] = 0.0        # all below threshold -> NaN, 0
    cms[1, 5, 6, 1] = 0.95       # clear peak
    cms[2, 0, 0, 2] = cms[2, 10, 12, 2] = 2.0  # tie at the corners, first wins
    cms[3, :, :, 0] = 0.0        # peak whose window holds zero mass
    cms[3, 2, 2, 0], cms[3, 2, 3, 0] = 1.0, -1.0
    want = jpeaks.find_global_peaks(jnp.asarray(cms), threshold=0.2, refinement=refinement)
    got = tpeaks.find_global_peaks(torch.from_numpy(cms), threshold=0.2, refinement=refinement)
    _assert_same(got, want, atol=1e-5)


def test_refine_global_peaks_zero_mass_and_nan():
    cms = np.zeros((1, 9, 9, 2), np.float32)
    cms[0, 4, 4, 1] = 1.0
    cms[0, 4, 5, 1] = -1.0  # window mass sums to zero -> zero offset
    rough = np.array([[[2.4, 3.6], [4.0, 4.0]]], np.float32)
    rough_nan = rough.copy()
    rough_nan[0, 0] = np.nan
    for r in (rough, rough_nan):
        want = jpeaks.refine_global_peaks_windowed(jnp.asarray(cms), jnp.asarray(r))
        got = tpeaks.refine_global_peaks_windowed(torch.from_numpy(cms), torch.from_numpy(r))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_integral_regression():
    crops = np.random.default_rng(3).random((5, 5, 5, 1), dtype=np.float32)
    crops[2] = 0.0
    gv = np.arange(5, dtype=np.float32) - 2.0
    want = jpeaks.integral_regression(jnp.asarray(crops), jnp.asarray(gv), jnp.asarray(gv))
    got = tpeaks.integral_regression(torch.from_numpy(crops), torch.from_numpy(gv),
                                     torch.from_numpy(gv))
    _assert_same(got, want, atol=1e-6)


def test_crop_bboxes_nan_and_clamped_starts():
    rng = np.random.default_rng(4)
    images = rng.random((3, 20, 24, 2), dtype=np.float32)
    cents = np.array([
        [10.3, 9.7],      # interior
        [0.0, 0.0],       # top-left corner: crop runs off the image
        [23.0, 19.0],     # bottom-right corner
        [np.nan, 5.0],    # invalid -> all-zero crop
        [-40.0, 2.5],     # start below the padded image: clamped
        [60.0, 70.0],     # start past the padded image: clamped
        [-1e6, -1e6],     # the top-down layer's stand-in for NaN centroids
        [7.5, 7.5],       # .5 positions exercise the legacy trunc floor
        [-3.5, 4.49],
    ], np.float32)
    inds = np.array([0, 1, 2, 0, 1, 2, 0, 1, 2], np.int32)
    for size in (5, 8):
        bb_j = jcrops.make_centered_bboxes(jnp.asarray(cents), size, size)
        bb_t = tcrops.make_centered_bboxes(torch.from_numpy(cents), size, size)
        np.testing.assert_array_equal(bb_t.numpy(), np.asarray(bb_j))
        want = jcrops.crop_bboxes(jnp.asarray(images), bb_j, jnp.asarray(inds), size, size)
        got = tcrops.crop_bboxes(torch.from_numpy(images), bb_t, torch.from_numpy(inds),
                                 size, size)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert not got[3].any()


@pytest.mark.parametrize("h,w,stride", [(8, 12, 1), (10, 7, 2), (16, 16, 4)])
def test_grid_vectors_and_gaussian(h, w, stride):
    from sleap_nn_tpu.ops import grid as jgrid
    from sleap_nn_tpu_torch.ops import grid as tgrid

    for got, want in zip(tgrid.make_grid_vectors(h, w, stride),
                         jgrid.make_grid_vectors(h, w, stride)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    x = np.linspace(-6, 6, 25, dtype=np.float32)
    np.testing.assert_allclose(tgrid.gaussian_pdf(torch.from_numpy(x), 1.5).numpy(),
                               np.asarray(jgrid.gaussian_pdf(jnp.asarray(x), 1.5)),
                               rtol=1e-6, atol=0)
