"""Fused double 3x3 conv block: a CUDA kernel and its plain PyTorch version.

Port of ``sleap_nn_tpu/ops/fused_conv.py``. Computes

    y = act(conv3x3(act(conv3x3(x) + b1)) + b2)

with SAME padding, NHWC activations and HWIO weights (the JAX layouts),
``act`` relu or identity. Numerics of the TPU kernel: weights rounded to
x's type, f32 accumulation, bias and activation in f32, the intermediate
("mid") rounded to x's type, and zero outside the image when conv2 reads it.

A CUDA tensor runs ``csrc/fused_double_conv3x3.cu`` (the intermediate
stays in shared memory); a CPU tensor runs :func:`_plain_double_conv`.
In bf16 the kernel is an implicit GEMM on the tensor cores; its tile comes
from :func:`plan_tiles` and its weights from :func:`pack_weight` (packed
once per weight tensor and version, see :func:`_packed`). f32 runs a
CUDA-core kernel with a fixed 8 x 16 tile.

A UNet decoder block's input, ``concat(skip, upsample2x(low))``, may be
given as its two parts (``upsample=low``): the bf16 kernel then builds it
in shared memory as it reads them, and the upsampled map and the concat
never exist in device memory.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from sleap_nn_tpu_torch import profiling
from sleap_nn_tpu_torch.data.resizing import resize_bilinear
from sleap_nn_tpu_torch.ops import library
from sleap_nn_tpu_torch.ops._build import Kernel

_ACTS = ("relu", "identity")

KERNEL = Kernel(
    "fused_double_conv3x3", "fused_double_conv3x3.cu",
    [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
)


def _act(v: torch.Tensor, activation: str) -> torch.Tensor:
    return torch.relu(v) if activation == "relu" else v


def _plain_double_conv(x, w1, b1, w2, b2, activation="relu", upsample=None):
    """Plain PyTorch version of the kernel, with the same roundings.

    The mid tensor is computed over the image only and zero-padded before
    conv2, which is the kernel's zeroing of mid outside the image.
    ``upsample``: as :func:`fused_double_conv3x3`'s, concatenated first.
    """
    if upsample is not None:
        x = _concat_upsampled(x, upsample)
    dt = x.dtype

    def conv(v, w, b):  # SAME 3x3 in f32: zero pad, then VALID conv
        y = F.conv2d(F.pad(v, (1, 1, 1, 1)), w.to(dt).float().permute(3, 2, 0, 1))
        if b is not None:
            y = y + b.float()[:, None, None]
        return _act(y, activation)

    mid = conv(x.float().permute(0, 3, 1, 2), w1, b1).to(dt).float()
    out = conv(mid, w2, b2).to(dt)
    return out.permute(0, 2, 3, 1).contiguous()


# --------------------------------------------------------------------------
# The bf16 tensor-core kernel's tile planner (mirrors csrc/.../tc::layout).
# --------------------------------------------------------------------------

SMEM_LIMIT = 232_448    # dynamic shared memory one block may take on an H100
SMEM_PER_SM = 233_472   # shared memory of one SM, for all its resident blocks
N_SM = 132              # SMs of an H100 SXM
WARPS, WM, WN = 8, 2, 8  # the kernel's warps; its m16 tiles and (at most) n8 tiles of a pass
KC, NST = 4, 3           # k-steps of a staged weight chunk; chunks in the ring
WBUF = NST * KC * WN * 32 * 8  # bytes of the weight ring
# The kernel's variants: (resident blocks an SM it is built for, n8 tiles of a pass).
VARIANTS = ((2, 6), (1, 8))
# Output tiles the planner weighs: 14 and 30 make a 16 x 16 or 32 x 32 mid tile.
TILES = tuple((th, tw) for th in (4, 6, 8, 14, 16, 30, 32) for tw in (8, 14, 16, 30, 32)
              if th <= tw)
# Cost model rates (per SM and cycle): mma.sync m16n8k16 issued, bytes from L2.
MMA_RATE, L2_RATE = 0.5, 20.0


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _row_units(c: int) -> int:
    """16-byte units of one pixel row in shared memory: c padded to 8, then
    to an odd count of units (consecutive pixels on distinct bank groups)."""
    return _ceil(c, 8) | 1


def _k_groups(c_in: int) -> int:
    """8-channel K groups of a conv: 9 taps x the channels padded to 8, or,
    for one input channel, the 9 taps folded into 16 (two groups)."""
    return 2 if c_in == 1 else 9 * _ceil(c_in, 8)


def smem_bytes(th: int, tw: int, c_in: int, c_mid: int, c_out: int) -> int:
    """Dynamic shared memory of one block: a zero row, the K-group offset
    table, the weight ring, the bf16 mid tile, then the conv1 source (the
    input halo; for c_in = 1 the im2col tile before it) shared with the
    staged output tile."""
    mpix = (th + 2) * (tw + 2)
    ktab = _ceil(4 * 2 * _ceil(max(_k_groups(c_in), _k_groups(c_mid)), 2), 16) * 16
    mid = mpix * _row_units(c_mid) * 16
    src = (th + 4) * (tw + 4) * _row_units(c_in) * 16 + (mpix * 3 * 16 if c_in == 1 else 0)
    return 16 + ktab + WBUF + mid + _ceil(max(src, th * tw * c_out * 2), 16) * 16


def _gemm_cost(m: int, groups: int, n_tiles: int, wn_max: int) -> Tuple[int, int]:
    """(mma issue slots, weight bytes read from L2) of one block's conv GEMM:
    m output pixels, ``groups`` 8-channel K groups, n8 tiles in passes of at
    most ``wn_max``. The warps work in step, so a pass costs its full
    WARPS x WM x wn slots a k-step."""
    ksteps = _ceil(groups, 2)
    passes_m, nc = _ceil(_ceil(m, 16), WARPS * WM), _ceil(n_tiles, wn_max)
    wn = _ceil(n_tiles, nc)
    slots = passes_m * nc * ksteps * WARPS * WM * wn
    return slots, passes_m * ksteps * n_tiles * 256


@dataclass(frozen=True)
class TilePlan:
    tile_h: int
    tile_w: int
    smem_bytes: int
    blocks: int          # grid size: batch x tiles
    blocks_per_sm: int   # the kernel variant: built for 2 resident blocks an SM, or 1
    cost: float          # modelled time, in SM cycles


@functools.lru_cache(maxsize=None)
def plan_tiles(bsz: int, h: int, w: int, c_in: int, c_mid: int, c_out: int) -> TilePlan:
    """The output tile of the bf16 kernel for one call shape.

    A cost model over :data:`TILES` that fit :data:`SMEM_LIMIT`: each
    block's mma issue slots for both convs (the mid recompute, M and N
    padding, warps idle in a pass) at :data:`MMA_RATE`, its weight and
    halo bytes at :data:`L2_RATE` (overlapped with the other block's work
    when two fit on an SM), and the waves of blocks over the card's SMs.
    Large tiles win for narrow blocks, small ones for wide blocks and small
    maps. Raises if no tile fits.
    """
    best = None
    for (th, tw), (minb, wn_max) in itertools.product(TILES, VARIANTS):
        smem = smem_bytes(th, tw, c_in, c_mid, c_out)
        if smem > SMEM_LIMIT:
            continue
        blocks = bsz * _ceil(h, th) * _ceil(w, tw)
        slots1, bytes1 = _gemm_cost((th + 2) * (tw + 2), _k_groups(c_in), _ceil(c_mid, 8), wn_max)
        slots2, bytes2 = _gemm_cost(th * tw, _k_groups(c_mid), _ceil(c_out, 8), wn_max)
        occ = max(1, min(minb, SMEM_PER_SM // (smem + 1024)))
        t_mma = (slots1 + slots2) / MMA_RATE
        t_mem = (bytes1 + bytes2 + (th + 4) * (tw + 4) * c_in * 2) / L2_RATE
        wave = occ * max(t_mma, t_mem) if occ > 1 else t_mma + t_mem
        cost = _ceil(blocks, N_SM * occ) * wave
        if best is None or cost < best.cost:
            best = TilePlan(th, tw, smem, blocks, minb, cost)
    if best is None:
        raise ValueError(f"fused_double_conv3x3: no tile fits {SMEM_LIMIT} bytes of shared "
                         f"memory for {c_in} -> {c_mid} -> {c_out} channels")
    return best


# --------------------------------------------------------------------------
# Weight packing
# --------------------------------------------------------------------------


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, I, O) -> the bf16 kernel's B operand, ``(ksteps, n_tiles,
    32, 4)`` bf16 in mma.m16n8k16 fragment order, rounded to bf16 first.

    K runs over (tap, input channel) with the channels padded to 8 (for
    I = 1: the 9 taps alone), then padded to 16; N is O padded to 8; pads
    are 0. Entry ``[s, t, lane, j]`` is ``K[16 s + k, 8 t + lane // 4]``
    with ``k = 2 (lane % 4) + j % 2 + 8 (j // 2)``.
    """
    c_in, c_out = w.shape[2], w.shape[3]
    wf = w.to(torch.bfloat16).float()
    if c_in == 1:
        k = wf.reshape(9, c_out)
    else:
        k = F.pad(wf.reshape(9, c_in, c_out), (0, 0, 0, -c_in % 8)).reshape(-1, c_out)
    n_tiles = _ceil(c_out, 8)
    k = F.pad(k, (0, 8 * n_tiles - c_out, 0, -k.shape[0] % 16))
    lane = torch.arange(32, device=w.device)[:, None]
    j = torch.arange(4, device=w.device)[None, :]
    kk = (lane % 4) * 2 + j % 2 + 8 * (j // 2)  # (32, 4)
    frag = k.reshape(-1, 16, n_tiles, 8)[:, kk, :, (lane // 4).expand(32, 4)]
    return frag.permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()


def _pack_weight_f32(w: torch.Tensor) -> torch.Tensor:
    """HWIO (3, 3, I, O) -> (9, I, O padded to 4) f32, the f32 kernel's layout."""
    o = w.shape[3]
    return F.pad(w.float().reshape(9, w.shape[2], o), (0, -o % 4)).contiguous()


def _pack(w: torch.Tensor, b: Optional[torch.Tensor], dtype: torch.dtype):
    """(weight, f32 bias) as the kernel for ``dtype`` reads them."""
    n = w.shape[3]
    w = w.detach()
    bias = torch.zeros(n, dtype=torch.float32, device=w.device) if b is None else b.detach().float()
    if dtype == torch.bfloat16:
        return pack_weight(w), F.pad(bias, (0, -n % 8)).contiguous()
    return _pack_weight_f32(w), bias.contiguous()


# Packed weights by id of the weight's base tensor (a module's parameter:
# the UNet passes HWIO views of it): (weakref, key, packed).
_PACKS: Dict[int, tuple] = {}


def _packed(w: torch.Tensor, b: Optional[torch.Tensor], dtype: torch.dtype):
    """:func:`_pack`, computed once per weight and reused until the weight
    or its bias changes (another storage, an in-place update, a new view)."""
    base = w if w._base is None else w._base
    if w.is_inference() or (b is not None and b.is_inference()):
        return _pack(w, b, dtype)  # no version counter to watch
    key = (dtype, w.data_ptr(), w._version, tuple(w.shape), w.stride(),
           None if b is None else (b.data_ptr(), b._version, tuple(b.shape)))
    hit = _PACKS.get(id(base))
    if hit is not None and hit[0]() is base and hit[1] == key:
        return hit[2]
    packed = _pack(w, b, dtype)
    ref = weakref.ref(base, lambda _, i=id(base): _PACKS.pop(i, None))
    _PACKS[id(base)] = (ref, key, packed)
    return packed


# --------------------------------------------------------------------------
# The wrapper
# --------------------------------------------------------------------------


def _launch(x: torch.Tensor, pw1, pw2, y: torch.Tensor, c_mid: int, activation: str,
            low: Optional[torch.Tensor] = None) -> None:
    """Launch the kernel on packed weights ``pw1`` / ``pw2`` (from
    :func:`_packed`) into the preallocated ``y``, on the current stream;
    ``low``: the input's upsampled second part (bf16 only)."""
    bsz, h, w, c_skip = x.shape
    c_in = c_skip + (0 if low is None else low.shape[3])
    c_out = y.shape[3]
    th = tw = minb = 0  # the f32 kernel's tile is fixed
    if x.dtype == torch.bfloat16:
        plan = plan_tiles(bsz, h, w, c_in, c_mid, c_out)
        th, tw, minb = plan.tile_h, plan.tile_w, plan.blocks_per_sm
    KERNEL.launch(
        x.data_ptr(), None if low is None else low.data_ptr(), pw1[0].data_ptr(),
        pw1[1].data_ptr(), pw2[0].data_ptr(), pw2[1].data_ptr(), y.data_ptr(), bsz, h, w,
        c_in, c_skip, c_mid, c_out, int(activation == "relu"), int(x.dtype == torch.bfloat16),
        th, tw, minb, torch.cuda.current_stream().cuda_stream,
    )


def fused_double_conv3x3(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: Optional[torch.Tensor],
    w2: torch.Tensor,
    b2: Optional[torch.Tensor],
    activation: str = "relu",
    upsample: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """act(conv3x3(act(conv3x3(x)+b1))+b2), SAME padding, NHWC/HWIO.

    x: (B, H, W, C_in) bf16 or f32, contiguous; w1: (3, 3, C_in, C_mid);
    w2: (3, 3, C_mid, C_out); biases (C) or None. Returns (B, H, W, C_out)
    in x's type. CUDA tensors launch the kernel, CPU tensors take the
    plain version. The kernel is forward only: on CUDA tensors it raises
    when autograd is on and any input requires a gradient. While
    ``torch.export`` traces it calls the registered operator.

    ``upsample``: a (B, H/2, W/2, C_l) map of x's type, contiguous; the
    input is then ``concat([x, bilinear_upsample(upsample)], -1)`` and w1
    has C_s + C_l input channels (C_s: x's). The bf16 kernel builds that
    concat as it reads the two (the counter ``decoder.fused_upsample``
    1); the plain version, the f32 kernel and the registered operator
    take it computed first (0).
    """
    if upsample is not None:
        _check_upsample(x, upsample)
        if library.tracing_active() or x.device.type != "cuda" or x.dtype != torch.bfloat16:
            x, upsample = _concat_upsampled(x, upsample), None
        profiling.count("decoder.fused_upsample", int(upsample is not None))
    if library.tracing_active():
        return library.OPS["fused_double_conv3x3"](x, w1, b1, w2, b2, activation)
    with profiling.span("kernel.fused_double_conv3x3"):
        return _fused_double_conv3x3(x, w1, b1, w2, b2, activation, upsample)


def _check_upsample(x, low) -> None:
    """Raise unless ``low`` can stand for x's half-size second part (the
    channels are checked against w1 with x's)."""
    if low.ndim != 4 or x.ndim != 4 or low.shape[0] != x.shape[0] \
            or 2 * low.shape[1] != x.shape[1] or 2 * low.shape[2] != x.shape[2]:
        raise ValueError(f"upsample must be (B, H/2, W/2, C) for x {tuple(x.shape)}, "
                         f"got {tuple(low.shape)}")
    if low.dtype != x.dtype:
        raise TypeError(f"upsample must be {x.dtype} like x, got {low.dtype}")
    if not low.is_contiguous():
        raise ValueError("upsample must be contiguous (NHWC)")
    if low.device != x.device:
        raise ValueError(f"upsample must be on {x.device}, got {low.device}")


def _concat_upsampled(x, low):
    """The input the two parts stand for: ``concat([x, bilinear_upsample(low)], -1)``."""
    return torch.cat([x, resize_bilinear(low, x.shape[1], x.shape[2])], dim=-1)


def _fused_double_conv3x3(x, w1, b1, w2, b2, activation="relu", low=None):
    """:func:`fused_double_conv3x3`' body: the plain version on a CPU
    tensor, kernel 1 on a CUDA tensor (``low``: a checked bf16 second
    part)."""
    if activation not in _ACTS:
        raise ValueError(f"activation must be one of {_ACTS}, got {activation!r}")
    c_in = x.shape[-1] + (0 if low is None else low.shape[3])
    if x.ndim != 4 or w1.shape[:2] != (3, 3) or w2.shape[:2] != (3, 3) \
            or w1.shape[2] != c_in or w2.shape[2] != w1.shape[3]:
        raise ValueError(
            f"shapes do not chain: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, w2 {tuple(w2.shape)}")
    if x.device.type == "cpu":
        return _plain_double_conv(x, w1, b1, w2, b2, activation)
    if x.device.type != "cuda":
        raise ValueError(f"fused_double_conv3x3 runs on cuda or cpu tensors, got {x.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in (x, low, w1, b1, w2, b2)):
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
    bsz, h, w, _ = x.shape
    c_mid, c_out = w1.shape[3], w2.shape[3]
    y = torch.empty((bsz, h, w, c_out), dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    # The bf16 kernel reads x and low in aligned 16-byte chunks.
    if x.data_ptr() % 16:
        x = x.clone()
    if low is not None and low.data_ptr() % 16:
        low = low.clone()
    with torch.cuda.device(x.device):
        _launch(x, _packed(w1, b1, x.dtype), _packed(w2, b2, x.dtype), y, c_mid, activation, low)
    return y
