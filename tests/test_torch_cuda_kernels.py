"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips without a CUDA device (the decision is
made inside the fixture, never at import). On a machine with an NVIDIA
GPU and nvcc:

    python -m pytest -m cuda tests/test_torch_cuda_kernels.py -q

Tolerances: the NMS score map exactly; the fused conv in f32 to 1e-4 of
the output's largest magnitude (sums in another order) and in bf16 to one
bf16 ulp at that magnitude (a mid value within an f32 rounding error of a
bf16 tie may round the other way in the two versions).
"""

import numpy as np
import pytest
import torch

from sleap_nn_tpu_torch.ops.fused_conv import KERNEL, _plain_double_conv, fused_double_conv3x3
from sleap_nn_tpu_torch.ops.kernels import NMS_SCORES, _plain_nms_scores, nms_scores

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["relu", "identity"])
@pytest.mark.parametrize(
    "shape,c_mid,c_out",
    [((1, 7, 9, 1), 4, 3), ((2, 13, 21, 5), 24, 24), ((1, 9, 17, 303), 121, 121),
     ((3, 33, 40, 17), 7, 5)],
)
def test_fused_conv_kernel_matches_plain(cuda, shape, c_mid, c_out, activation, dtype):
    rng = np.random.default_rng(sum(shape))
    c_in = shape[-1]
    x = torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(cuda, dtype)
    w1 = torch.from_numpy(rng.standard_normal((3, 3, c_in, c_mid), dtype=np.float32)
                          / np.sqrt(9 * c_in)).to(cuda)
    w2 = torch.from_numpy(rng.standard_normal((3, 3, c_mid, c_out), dtype=np.float32)
                          / np.sqrt(9 * c_mid)).to(cuda)
    b1 = torch.from_numpy(rng.standard_normal(c_mid, dtype=np.float32) * 0.1).to(cuda)
    b2 = torch.from_numpy(rng.standard_normal(c_out, dtype=np.float32) * 0.1).to(cuda)
    before = KERNEL.launches
    got = fused_double_conv3x3(x, w1, b1, w2, b2, activation)
    want = _plain_double_conv(x, w1, b1, w2, b2, activation)
    torch.cuda.synchronize()
    assert KERNEL.launches == before + 1
    assert got.dtype == dtype and got.shape == (*shape[:3], c_out)
    top = want.float().abs().max().item()
    tol = 2.0 ** (np.floor(np.log2(top)) - 7) if dtype == torch.bfloat16 else 1e-4 * top
    assert (got.float() - want.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kernel", [3, 5])
def test_nms_kernel_matches_plain_exactly(cuda, kernel, dtype):
    cms = torch.from_numpy(np.random.default_rng(kernel).random((2, 37, 45, 3),
                                                                dtype=np.float32))
    cms[0, 5, 5, 1] = float("nan")
    cms = cms.to(cuda, dtype)
    before = NMS_SCORES.launches
    got = nms_scores(cms, 0.3, kernel)
    assert NMS_SCORES.launches == before + 1
    assert torch.equal(got, _plain_nms_scores(cms, 0.3, kernel))


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(1, 4, 4, 2, device=cuda, dtype=torch.float16)
    w = torch.zeros(3, 3, 2, 2, device=cuda)
    with pytest.raises(TypeError):
        fused_double_conv3x3(x, w, None, w, None)
    with pytest.raises(ValueError, match="contiguous"):
        fused_double_conv3x3(x.float().transpose(1, 2), w, None, w, None)
    with pytest.raises(TypeError):
        nms_scores(torch.zeros(1, 4, 4, 1, device=cuda, dtype=torch.float16), 0.2)
