"""Fused double 3x3 conv block: a CUDA kernel and its plain PyTorch version.

Port of ``sleap_nn_tpu/ops/fused_conv.py``. Computes

    y = act(conv3x3(act(conv3x3(x) + b1)) + b2)

with SAME padding, NHWC activations and HWIO weights (the JAX layouts),
``act`` relu or identity. Numerics of the TPU kernel: weights rounded to
x's type, f32 accumulation, bias and activation in f32, the intermediate
("mid") rounded to x's type, and zero outside the image when conv2 reads it.

A CUDA tensor runs ``csrc/fused_double_conv3x3.cu`` (the intermediate
stays in shared memory); a CPU tensor runs :func:`_plain_double_conv`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from sleap_nn_tpu_torch.ops._build import Kernel

_ACTS = ("relu", "identity")

KERNEL = Kernel(
    "fused_double_conv3x3", "fused_double_conv3x3.cu",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p],
)


def _act(v: torch.Tensor, activation: str) -> torch.Tensor:
    return torch.relu(v) if activation == "relu" else v


def _plain_double_conv(x, w1, b1, w2, b2, activation="relu"):
    """Plain PyTorch version of the kernel, with the same roundings.

    The mid tensor is computed over the image only and zero-padded before
    conv2, which is the kernel's zeroing of mid outside the image.
    """
    dt = x.dtype

    def conv(v, w, b):  # SAME 3x3 in f32: zero pad, then VALID conv
        y = F.conv2d(F.pad(v, (1, 1, 1, 1)), w.to(dt).float().permute(3, 2, 0, 1))
        if b is not None:
            y = y + b.float()[:, None, None]
        return _act(y, activation)

    mid = conv(x.float().permute(0, 3, 1, 2), w1, b1).to(dt).float()
    out = conv(mid, w2, b2).to(dt)
    return out.permute(0, 2, 3, 1).contiguous()


def _pack_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """HWIO (3, 3, I, O) -> (9, I, O padded to 4) f32, rounded to ``dtype`` first."""
    o = w.shape[3]
    return F.pad(w.to(dtype).float().reshape(9, w.shape[2], o), (0, -o % 4)).contiguous()


def _bias(b: Optional[torch.Tensor], n: int, x: torch.Tensor) -> torch.Tensor:
    if b is None:
        return torch.zeros(n, dtype=torch.float32, device=x.device)
    return b.float().contiguous()


def fused_double_conv3x3(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: Optional[torch.Tensor],
    activation: str = "relu",
) -> torch.Tensor:
    """act(conv3x3(act(conv3x3(x)+b1))+b2), SAME padding, NHWC/HWIO.

    x: (B, H, W, C_in) bf16 or f32, contiguous; w1: (3, 3, C_in, C_mid);
    w2: (3, 3, C_mid, C_out); biases (C) or None. Returns (B, H, W, C_out)
    in x's type. CUDA tensors launch the kernel, CPU tensors take the
    plain version. The kernel is forward only: on CUDA tensors it raises
    when autograd is on and any input requires a gradient.
    """
    if activation not in _ACTS:
        raise ValueError(f"activation must be one of {_ACTS}, got {activation!r}")
    if x.ndim != 4 or w1.shape[:2] != (3, 3) or w2.shape[:2] != (3, 3) \
            or w1.shape[2] != x.shape[3] or w2.shape[2] != w1.shape[3]:
        raise ValueError(
            f"shapes do not chain: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if x.device.type == "cpu":
        return _plain_double_conv(x, w1, b1, w2, b2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_double_conv3x3 runs on cuda or cpu tensors, got {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, w1, b1, w2, b2)):
        # The kernel writes its result through a raw pointer, so autograd
        # would see a leaf: nothing below the block would get a gradient.
        raise RuntimeError(
            "fused_double_conv3x3 has no backward (nor has the TPU kernel it ports): "
            "call it under torch.no_grad() / inference_mode, or train with use_fused=False")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (NHWC)")
    for t in (w1, b1, w2, b2):
        if t is not None and t.device != x.device:
            raise ValueError(f"weights must be on {x.device}, got {t.device}")
    bsz, h, w, c_in = x.shape
    c_mid, c_out = w1.shape[3], w2.shape[3]
    w1p, w2p = _pack_weight(w1, x.dtype), _pack_weight(w2, x.dtype)
    b1f, b2f = _bias(b1, c_mid, x), _bias(b2, c_out, x)
    y = torch.empty((bsz, h, w, c_out), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    with torch.cuda.device(x.device):
        KERNEL.launch(
            x.data_ptr(), w1p.data_ptr(), b1f.data_ptr(), w2p.data_ptr(),
            b2f.data_ptr(), y.data_ptr(), bsz, h, w, c_in, c_mid, c_out,
            w1p.shape[2], w2p.shape[2], int(activation == "relu"),
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    return y
