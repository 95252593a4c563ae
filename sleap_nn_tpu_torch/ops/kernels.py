"""Hand-written CUDA kernels of the port's hot ops, each beside its plain
PyTorch version.

Port of ``sleap_nn_tpu/ops/pallas_kernels.py``. A CUDA tensor launches the
kernel; a CPU tensor takes the plain version. Ported so far:

- :func:`nms_scores` (``csrc/nms_scores.cu``), for ``nms_scores_pallas``.

Still to port: ``paf_line_samples_pallas`` (bottom-up inference) and
``make_multi_confmaps_pallas`` (training targets).
"""

from __future__ import annotations

import ctypes

import torch

from sleap_nn_tpu_torch.ops._build import Kernel

NMS_SCORES = Kernel(
    "nms_scores", "nms_scores.cu",
    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)


def _plain_nms_scores(cms: torch.Tensor, threshold: float, kernel: int = 3) -> torch.Tensor:
    """``where((cms > nms_max_pool(cms)) & (cms > threshold), cms, -inf)`` in f32."""
    from sleap_nn_tpu_torch.ops.peaks import nms_max_pool

    f = cms.float()
    is_peak = (f > nms_max_pool(f, kernel)) & (f > threshold)
    return torch.where(is_peak, f, torch.tensor(float("-inf"), device=f.device))


def nms_scores(cms: torch.Tensor, threshold: float, kernel: int = 3) -> torch.Tensor:
    """Fused strict-local-max + threshold score map.

    ``cms``: channel-last ``(B, H, W, C)`` bf16 or f32. Returns f32 of the
    same shape: the value where it strictly exceeds its ``kernel x kernel``
    neighbourhood (outside cells count as -inf) and ``threshold``, -inf
    elsewhere. The output feeds the top-K of ``find_local_peaks_rough``.
    """
    if kernel % 2 != 1 or kernel < 3:
        raise ValueError(f"NMS kernel must be an odd int >= 3, got {kernel}")
    if cms.ndim != 4:
        raise ValueError(f"cms must be (B, H, W, C), got {tuple(cms.shape)}")
    if cms.device.type == "cpu":
        return _plain_nms_scores(cms, threshold, kernel)
    if cms.device.type != "cuda":
        raise ValueError(f"nms_scores runs on cuda or cpu tensors, got {cms.device}")
    if cms.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cms must be float32 or bfloat16, got {cms.dtype}")
    if not cms.is_contiguous():
        raise ValueError("cms must be contiguous (NHWC)")
    b, h, w, c = cms.shape
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=cms.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(cms.device):
        NMS_SCORES.launch(
            cms.data_ptr(), out.data_ptr(), b, h, w, c, kernel, float(threshold),
            int(cms.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    return out
