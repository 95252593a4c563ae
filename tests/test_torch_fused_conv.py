"""Port parity: fused double 3x3 conv (sleap_nn_tpu_torch.ops.fused_conv).

The JAX side runs the Pallas kernel in interpret mode and its plain XLA
path; the port side runs the plain PyTorch version that CPU tensors take.
Inputs are drawn with numpy. Tolerances: f32 1e-5 (sums in another
order); bf16 compared in f32 after both round to bf16, to 2 bf16 ulps at
the output's scale (a mid value within an f32 rounding error of a bf16
tie may round the other way and move an output by a fraction of an ulp).
"""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from sleap_nn_tpu.ops.fused_conv import _plain_double_conv as jax_plain
from sleap_nn_tpu.ops.fused_conv import fused_double_conv3x3 as jax_fused
from sleap_nn_tpu_torch.ops.fused_conv import _plain_double_conv, fused_double_conv3x3


def _inputs(shape, c_mid, c_out, seed, bias=True):
    rng = np.random.default_rng(seed)
    c_in = shape[3]
    x = rng.standard_normal(shape).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, c_in, c_mid)) * 0.3).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, c_mid, c_out)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal(c_mid) * 0.1).astype(np.float32) if bias else None
    b2 = (rng.standard_normal(c_out) * 0.1).astype(np.float32) if bias else None
    return x, w1, b1, w2, b2


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize(
    "shape,c_mid,c_out,bias,activation",
    [
        ((2, 7, 9, 1), 4, 3, True, "relu"),      # odd H/W, C_in=1 (enc0-like)
        ((1, 8, 5, 3), 5, 6, True, "relu"),      # odd W, C_in=3
        ((1, 12, 11, 5), 3, 4, False, "relu"),   # odd W, C_in=5, no bias
        ((2, 4, 8, 5), 4, 4, True, "identity"),
    ],
)
def test_plain_matches_jax_f32(shape, c_mid, c_out, bias, activation):
    x, w1, b1, w2, b2 = _inputs(shape, c_mid, c_out, seed=sum(shape), bias=bias)
    got = fused_double_conv3x3(_t(x), _t(w1), _t(b1), _t(w2), _t(b2), activation).numpy()
    plain = jax_plain(_j(x), _j(w1), _j(b1), _j(w2), _j(b2), activation)
    np.testing.assert_allclose(got, np.asarray(plain), atol=1e-5, rtol=1e-5)
    if shape[1] % 4 == 0:  # the Pallas kernel's row strips need H % 4 == 0
        kern = jax_fused(_j(x), _j(w1), _j(b1), _j(w2), _j(b2), activation=activation,
                         interpret=True)
        np.testing.assert_allclose(got, np.asarray(kern), atol=1e-5, rtol=1e-5)


def test_plain_matches_jax_kernel_bf16():
    x, w1, b1, w2, b2 = _inputs((1, 8, 10, 3), 6, 5, seed=11)
    xb = x.astype(ml_dtypes.bfloat16)
    got = fused_double_conv3x3(
        torch.from_numpy(xb.astype(np.float32)).to(torch.bfloat16),
        _t(w1), _t(b1), _t(w2), _t(b2)).float().numpy()
    want = np.asarray(jax_fused(jnp.asarray(xb), _j(w1), _j(b1), _j(w2), _j(b2),
                                interpret=True)).astype(np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_array_less(np.abs(got - want), 2 * ulp + 1e-30)


def test_cpu_wrapper_is_the_plain_version():
    x, w1, b1, w2, b2 = _inputs((1, 4, 4, 2), 3, 3, seed=3)
    args = (_t(x), _t(w1), _t(b1), _t(w2), _t(b2))
    torch.testing.assert_close(fused_double_conv3x3(*args), _plain_double_conv(*args),
                               rtol=0, atol=0)


def test_rejects_bad_arguments():
    x, w1, b1, w2, b2 = _inputs((1, 4, 4, 2), 3, 3, seed=4)
    with pytest.raises(ValueError, match="activation"):
        fused_double_conv3x3(_t(x), _t(w1), _t(b1), _t(w2), _t(b2), "sigmoid")
    with pytest.raises(ValueError, match="chain"):
        fused_double_conv3x3(_t(x), _t(w2), _t(b1), _t(w1), _t(b2))
