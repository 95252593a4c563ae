"""Port parity: peak NMS score map (sleap_nn_tpu_torch.ops.kernels.nms_scores).

The JAX side runs the Pallas kernel ``nms_scores_pallas`` in interpret
mode; the port side runs the plain PyTorch version that CPU tensors take.
Both compare in f32, so the maps must be exactly equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.ops.pallas_kernels import nms_scores_pallas
from sleap_nn_tpu.ops.peaks import nms_max_pool as jax_nms_max_pool
from sleap_nn_tpu_torch.ops.kernels import nms_scores
from sleap_nn_tpu_torch.ops.peaks import nms_max_pool


def _maps(shape, seed, levels=None):
    rng = np.random.default_rng(seed)
    if levels:  # few distinct values: many plateaus and tied neighbours
        return (rng.integers(0, levels, shape) / levels).astype(np.float32)
    return rng.random(shape, dtype=np.float32)


@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize(
    "shape,threshold,levels",
    [((2, 17, 23, 1), 0.2, None), ((1, 12, 9, 3), 0.5, None), ((2, 10, 14, 2), 0.1, 4)],
)
def test_plain_matches_pallas_exactly(kernel, shape, threshold, levels):
    cms = _maps(shape, seed=kernel + sum(shape), levels=levels)
    want = np.asarray(nms_scores_pallas(jnp.asarray(cms), threshold, kernel=kernel,
                                        interpret=True))
    got = nms_scores(torch.from_numpy(cms), threshold, kernel=kernel).numpy()
    np.testing.assert_array_equal(got, want)


def test_nms_max_pool_matches_jax_with_nan():
    cms = _maps((1, 8, 9, 2), seed=5)
    cms[0, 3, 4, 1] = np.nan
    want = np.asarray(jax_nms_max_pool(jnp.asarray(cms), kernel=3))
    got = nms_max_pool(torch.from_numpy(cms), kernel=3).numpy()
    np.testing.assert_array_equal(got, want)


def test_bf16_maps_score_in_f32():
    cms = _maps((1, 6, 7, 1), seed=6)
    b16 = torch.from_numpy(cms).to(torch.bfloat16)
    got = nms_scores(b16, 0.2)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got, nms_scores(b16.float(), 0.2), rtol=0, atol=0)


def test_rejects_even_kernel():
    with pytest.raises(ValueError, match="odd"):
        nms_scores(torch.zeros(1, 4, 4, 1), 0.2, kernel=4)
