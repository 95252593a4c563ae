"""Hand-written CUDA kernels of the port's hot ops, each beside its plain
PyTorch version.

Port of ``sleap_nn_tpu/ops/pallas_kernels.py``. A CUDA tensor launches the
kernel; a CPU tensor takes the plain version. Ported so far:

- :func:`nms_scores` (``csrc/nms_scores.cu``), for ``nms_scores_pallas``;
- :func:`paf_line_scores` (``csrc/paf_line_scores.cu``), for
  ``paf_line_samples_pallas`` fused with the rest of the JAX package's
  ``score_paf_lines_dense``;
- :func:`multi_confmaps` (``csrc/multi_confmaps.cu``), for
  ``make_multi_confmaps_pallas`` (training targets).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from sleap_nn_tpu_torch.ops import library
from sleap_nn_tpu_torch.ops._build import Kernel

NMS_SCORES = Kernel(
    "nms_scores", "nms_scores.cu",
    [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p],
)
PAF_LINE_SCORES = Kernel(
    "paf_line_scores", "paf_line_scores.cu",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_float] * 3 + [ctypes.c_void_p],
)
MULTI_CONFMAPS = Kernel(
    "multi_confmaps", "multi_confmaps.cu",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_float] * 2 + [ctypes.c_void_p] * 2,
)

# expf(-x) is exactly 0 in f32 for x above about 103.97 (the last denormal),
# so a Gaussian term whose d^2 / denom exceeds this cutoff renders 0 with
# margin. Kernel 4 skips every point whose bound over a tile exceeds it.
CONFMAP_CUTOFF = 110.0
# Kernel 4's output tile (elements, where N allows) and its per-node lists
# of live points (entries over all nodes) in shared memory.
_CONFMAP_TILE, _CONFMAP_LIST = 4096, 2048


def _device_guard(device: torch.device):
    """Make ``device`` current for a launch; a no-op where it already is."""
    if device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


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
    elsewhere. The output feeds the top-K of ``find_local_peaks_rough``. On
    the card ``kernel`` is 3 to 9. While ``torch.export`` traces it calls
    the registered operator.
    """
    if library.tracing_active():
        return library.OPS["nms_scores"](cms, float(threshold), int(kernel))
    return _nms_scores(cms, threshold, kernel)


def _nms_scores(cms: torch.Tensor, threshold: float, kernel: int = 3) -> torch.Tensor:
    """:func:`nms_scores`' body: the plain version on a CPU tensor, kernel
    2 on a CUDA tensor."""
    if kernel % 2 != 1 or kernel < 3:
        raise ValueError(f"NMS kernel must be an odd int >= 3, got {kernel}")
    if cms.ndim != 4:
        raise ValueError(f"cms must be (B, H, W, C), got {tuple(cms.shape)}")
    if cms.device.type == "cpu":
        return _plain_nms_scores(cms, threshold, kernel)
    if cms.device.type != "cuda":
        raise ValueError(f"nms_scores runs on cuda or cpu tensors, got {cms.device}")
    if kernel > 9:
        raise ValueError(f"the CUDA NMS kernel takes windows of 3 to 9, got {kernel}")
    if cms.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"cms must be float32 or bfloat16, got {cms.dtype}")
    if not cms.is_contiguous():
        raise ValueError("cms must be contiguous (NHWC)")
    b, h, w, c = cms.shape
    if cms.numel() >= 2**31 - 16:
        raise ValueError(f"nms_scores indexes in 32 bits: {cms.numel()} elements are too many")
    out = torch.empty((b, h, w, c), dtype=torch.float32, device=cms.device)
    if out.numel() == 0:
        return out
    if cms.data_ptr() % 16:  # the kernel reads cms in aligned 16-byte chunks
        cms = cms.clone()
    with _device_guard(cms.device):
        NMS_SCORES.launch(
            cms.data_ptr(), out.data_ptr(), b, h, w, c, kernel, float(threshold),
            int(cms.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream,
        )
    return out


def paf_line_subscripts(src: torch.Tensor, dst: torch.Tensor, t: torch.Tensor,
                        pafs_stride: float, hp: int, wp: int):
    """PAF pixel ``(ys, xs)`` of every line point, ``(B, E, Ks, Kd, P)`` int64 each.

    ``src`` / ``dst``: ``(B, E, K, 2)`` line ends. The point
    ``src + t * (dst - src)`` is rounded once, as the fused multiply-add
    that XLA emits under ``jit``: the sum is taken in f64 and rounded to f32
    (the f64 product of two f32 values is exact). Then true division by the
    stride, half-to-even rounding, and a clamp after the int conversion.
    """
    disp = dst[:, :, None, :, :] - src[:, :, :, None, :]  # (B, E, Ks, Kd, 2)
    pts = (src[:, :, :, None, None, :].double()
           + t.double()[:, None] * disp[..., None, :].double()).float()  # (B,E,Ks,Kd,P,2)
    # NaN ends belong to pairs that score -inf (or NaN); zero them before
    # the int conversion so no NaN is converted.
    sub = torch.round(torch.nan_to_num(pts / pafs_stride, nan=0.0)).to(torch.int32).long()
    return sub[..., 1].clamp(0, hp - 1), sub[..., 0].clamp(0, wp - 1)


def _plain_paf_line_scores(pafs: torch.Tensor, grouped_peaks: torch.Tensor,
                           grouped_mask: torch.Tensor, edge_inds: torch.Tensor,
                           t: torch.Tensor, pafs_stride: float, max_edge_length: float,
                           dist_penalty_weight: float) -> torch.Tensor:
    """The JAX package's jitted ``score_paf_lines_dense`` gather path, in PyTorch."""
    b, hp, wp, c = pafs.shape
    n_edges = edge_inds.shape[0]
    src_node, dst_node = edge_inds[:, 0].long(), edge_inds[:, 1].long()
    src = grouped_peaks[:, src_node]  # (B, E, K, 2)
    dst = grouped_peaks[:, dst_node]
    disp = dst[:, :, None, :, :] - src[:, :, :, None, :]  # (B, E, Ks, Kd, 2)
    length = torch.sqrt((disp ** 2).sum(dim=-1, keepdim=True))
    unit = disp / torch.clamp(length, min=1e-8)

    ys, xs = paf_line_subscripts(src, dst, t, pafs_stride, hp, wp)
    b_idx = torch.arange(b, device=pafs.device)[:, None, None, None, None]
    e_idx = torch.arange(n_edges, device=pafs.device)[None, :, None, None, None]
    flat = pafs.reshape(-1).float()
    at = ((b_idx * hp + ys) * wp + xs) * c + 2 * e_idx
    dots = flat[at] * unit[..., None, 0] + flat[at + 1] * unit[..., None, 1]  # (B,E,Ks,Kd,P)
    mean_scores = dots.mean(dim=-1)

    penalty = torch.clamp(max_edge_length / torch.clamp(length[..., 0], min=1e-8) - 1, max=0.0)
    scores = mean_scores + penalty * dist_penalty_weight

    src_mask = grouped_mask[:, src_node]
    dst_mask = grouped_mask[:, dst_node]
    pair_valid = src_mask[:, :, :, None] & dst_mask[:, :, None, :]
    finite = torch.isfinite(src[..., 0])[:, :, :, None] & torch.isfinite(dst[..., 0])[:, :, None, :]
    return torch.where(pair_valid & finite, scores,
                       torch.tensor(float("-inf"), device=scores.device))


def paf_line_scores(pafs: torch.Tensor, grouped_peaks: torch.Tensor,
                    grouped_mask: torch.Tensor, edge_inds: torch.Tensor, t: torch.Tensor,
                    pafs_stride: float, max_edge_length: float,
                    dist_penalty_weight: float) -> torch.Tensor:
    """Dense PAF line scores of every candidate pair of every edge.

    Args:
        pafs: ``(B, Hp, Wp, 2E)`` bf16 or f32, channel order
            ``[e0x, e0y, e1x, ...]``.
        grouped_peaks: ``(B, N, K, 2)`` f32 image-scale ``(x, y)``.
        grouped_mask: ``(B, N, K)`` bool.
        edge_inds: ``(E, 2)`` int32 ``(src_node, dst_node)``.
        t: ``(P,)`` f32 line fractions (``jnp.linspace(0, 1, P)``'s values).

    Returns:
        ``(B, E, K, K)`` f32: the mean over the P line points of the PAF
        sample (nearest PAF pixel) dotted with the unit displacement, plus
        ``dist_penalty_weight * min(max_edge_length / length - 1, 0)``;
        ``-inf`` where either endpoint is masked or its x is not finite.
    """
    if pafs.ndim != 4 or pafs.shape[-1] != 2 * edge_inds.shape[0]:
        raise ValueError(f"pafs must be (B, Hp, Wp, 2E) with E = {edge_inds.shape[0]}, "
                         f"got {tuple(pafs.shape)}")
    b, hp, wp, c = pafs.shape
    if grouped_peaks.ndim != 4 or grouped_peaks.shape[0] != b or grouped_peaks.shape[-1] != 2:
        raise ValueError(f"grouped_peaks must be (B, N, K, 2), got {tuple(grouped_peaks.shape)}")
    _, n, k, _ = grouped_peaks.shape
    if tuple(grouped_mask.shape) != (b, n, k):
        raise ValueError(f"grouped_mask must be {(b, n, k)}, got {tuple(grouped_mask.shape)}")
    if pafs.device.type == "cpu":
        return _plain_paf_line_scores(pafs, grouped_peaks, grouped_mask, edge_inds, t,
                                      pafs_stride, max_edge_length, dist_penalty_weight)
    if pafs.device.type != "cuda":
        raise ValueError(f"paf_line_scores runs on cuda or cpu tensors, got {pafs.device}")
    # One pass over what a caller can get wrong; the messages are built on failure only.
    args = {"pafs": pafs, "grouped_peaks": grouped_peaks, "grouped_mask": grouped_mask,
            "edge_inds": edge_inds, "t": t}
    if (pafs.dtype not in (torch.float32, torch.bfloat16) or grouped_peaks.dtype != torch.float32
            or grouped_mask.dtype != torch.bool or edge_inds.dtype != torch.int32
            or t.dtype != torch.float32):
        raise TypeError("paf_line_scores takes pafs float32 or bfloat16, grouped_peaks float32, "
                        "grouped_mask bool, edge_inds int32 and t float32; got "
                        + ", ".join(f"{name} {x.dtype}" for name, x in args.items()))
    index = pafs.get_device()
    if not (grouped_peaks.get_device() == grouped_mask.get_device() == edge_inds.get_device()
            == t.get_device() == index):
        raise ValueError("every input must lie on pafs' device; got "
                         + ", ".join(f"{name} on {x.device}" for name, x in args.items()))
    if not (pafs.is_contiguous() and grouped_peaks.is_contiguous()
            and grouped_mask.is_contiguous() and edge_inds.is_contiguous() and t.is_contiguous()):
        raise ValueError("every input must be contiguous; not contiguous: "
                         + ", ".join(name for name, x in args.items() if not x.is_contiguous()))
    if pafs.data_ptr() % (2 * pafs.element_size()):
        raise ValueError("pafs must be aligned to one (x, y) channel pair")
    if grouped_peaks.data_ptr() % 8:  # the kernel reads each (x, y) as one float2
        raise ValueError("grouped_peaks must be aligned to one (x, y) pair of 8 bytes")
    out = torch.empty((b, edge_inds.shape[0], k, k), dtype=torch.float32, device=pafs.device)
    if out.numel() == 0:
        return out
    with _device_guard(pafs.device):
        _launch_paf_line_scores(pafs, grouped_peaks, grouped_mask, edge_inds, t, out,
                                pafs_stride, max_edge_length, dist_penalty_weight)
    return out


def _launch_paf_line_scores(pafs, grouped_peaks, grouped_mask, edge_inds, t, out,
                            pafs_stride, max_edge_length, dist_penalty_weight) -> None:
    """Kernel 3's C entry on checked CUDA tensors, on the current stream."""
    b, hp, wp, _ = pafs.shape
    _, n, k, _ = grouped_peaks.shape
    PAF_LINE_SCORES.launch(
        pafs.data_ptr(), grouped_peaks.data_ptr(), grouped_mask.data_ptr(),
        edge_inds.data_ptr(), t.data_ptr(), out.data_ptr(),
        b, hp, wp, n, k, edge_inds.shape[0], t.shape[0], int(pafs.dtype == torch.bfloat16),
        float(pafs_stride), float(max_edge_length),
        float(dist_penalty_weight), torch.cuda.current_stream().cuda_stream,
    )


def make_confmaps(points: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor,
                  sigma: float) -> torch.Tensor:
    """Per-node Gaussian confidence maps of one instance set.

    ``points``: ``(..., n_nodes, 2)`` (x, y), NaN = missing (renders 0);
    ``xv`` ``(W,)`` and ``yv`` ``(H,)`` grid vectors; ``sigma`` in grid
    units. Returns ``(..., H, W, n_nodes)`` f32:
    ``exp(-((x - px)^2 + (y - py)^2) / (2 sigma^2))`` with an IEEE division
    by ``f32(2 sigma^2)``, as the JAX package computes it.
    """
    x = points[..., 0][..., None, None, :]  # (..., 1, 1, n_nodes)
    y = points[..., 1][..., None, None, :]
    xg = xv[None, :, None]  # (1, W, 1)
    yg = yv[:, None, None]  # (H, 1, 1)
    # A 0-dim tensor on the points' device: a Python scalar divisor becomes
    # a multiplication by its reciprocal in ATen's CUDA division.
    denom = torch.tensor(2 * sigma**2, dtype=torch.float32, device=points.device)
    cm = torch.exp(-((xg - x) ** 2 + (yg - y) ** 2) / denom)
    return torch.nan_to_num(cm)


def _plain_multi_confmaps(points: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor,
                          sigma: float) -> torch.Tensor:
    """The JAX package's jnp path: Gaussians of every instance, NaN -> 0, max over instances."""
    return make_confmaps(points, xv, yv, sigma).amax(dim=-4)


def multi_confmaps(points: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor,
                   sigma: float) -> torch.Tensor:
    """Multi-instance confidence maps of a batch.

    Args:
        points: ``(B, I, N, 2)`` f32 ``(x, y)``, NaN-padded instances/nodes.
        xv: ``(W,)`` f32 grid x coordinates; yv: ``(H,)`` f32 grid y.
        sigma: Gaussian std in grid units.

    Returns:
        ``(B, H, W, N)`` f32: per pixel and node, the max over instances of
        ``exp(-((x - px)^2 + (y - py)^2) / f32(2 sigma^2))``, each NaN term
        0 before the max.
    """
    if points.ndim != 4 or points.shape[-1] != 2:
        raise ValueError(f"points must be (B, I, N, 2), got {tuple(points.shape)}")
    if xv.ndim != 1 or yv.ndim != 1:
        raise ValueError(f"xv and yv must be 1-D, got {tuple(xv.shape)}, {tuple(yv.shape)}")
    if points.device.type == "cpu":
        return _plain_multi_confmaps(points, xv, yv, sigma)
    if points.device.type != "cuda":
        raise ValueError(f"multi_confmaps runs on cuda or cpu tensors, got {points.device}")
    for name, x in (("points", points), ("xv", xv), ("yv", yv)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if x.device != points.device:
            raise ValueError(f"{name} is on {x.device}, points on {points.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    b, n_inst, n_nodes, _ = points.shape
    h, w = yv.shape[0], xv.shape[0]
    out = torch.empty((b, h, w, n_nodes), dtype=torch.float32, device=points.device)
    if out.numel() == 0:
        return out
    if n_inst == 0:
        return out.zero_()
    with _device_guard(points.device):
        _launch_multi_confmaps(points, xv, yv, out, sigma)
    return out


def confmap_tile(n_nodes: int) -> Tuple[int, int]:
    """Kernel 4's output tile ``(rows, columns)`` in pixels for ``n_nodes``
    channels: columns a power of two up to 32, rows up to 32, at most 4096
    elements where ``n_nodes`` allows (32 x 32 at one node, 8 x 32 at 15)."""
    tw = 32
    while tw > 1 and tw * n_nodes > _CONFMAP_TILE:
        tw //= 2
    return min(32, max(1, _CONFMAP_TILE // (tw * n_nodes))), tw


def confmap_live_points(points: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor,
                        sigma: float) -> torch.Tensor:
    """Which points kernel 4's cull keeps in each of its tiles, computed on
    the host: ``(B, tiles_y, tiles_x, I, N)`` bool. A model of the kernel's
    rule (box of each tile's own grid values, NaN ignored; NaN points
    dropped; points whose box bound exceeds :data:`CONFMAP_CUTOFF` dropped
    unless the bound is not finite): the CPU tests hold it against the JAX
    package, and the card checks hold the kernel's own counts to it."""
    th, tw = confmap_tile(points.shape[2])
    inf = torch.tensor(float("inf"), device=points.device)

    def box(v: torch.Tensor, size: int):
        v = torch.cat([v, v.new_full(((-len(v)) % size,), float("nan"))]).reshape(-1, size)
        return (torch.where(v.isnan(), inf, v).amin(dim=1),
                torch.where(v.isnan(), -inf, v).amax(dim=1))

    (x_lo, x_hi), (y_lo, y_hi) = box(xv, tw), box(yv, th)
    px = points[:, None, None, :, :, 0]  # (B, 1, 1, I, N)
    py = points[:, None, None, :, :, 1]
    ex = torch.clamp(torch.maximum(x_lo[:, None, None] - px, px - x_hi[:, None, None]), min=0)
    ey = torch.clamp(torch.maximum(y_lo[:, None, None, None] - py,
                                   py - y_hi[:, None, None, None]), min=0)
    denom = torch.tensor(2 * sigma**2, dtype=torch.float32, device=points.device)
    bound = (ex * ex + ey * ey) / denom
    return ~px.isnan() & ~py.isnan() & ~(bound.isfinite() & (bound > CONFMAP_CUTOFF))


def confmap_cull_counts(points: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor,
                        sigma: float) -> Tuple[int, int, int]:
    """The host model's counts of what kernel 4's cull keeps: the tiles with
    a live point, the terms computed (live points x the tile's pixels), and
    the tiles in all. Given a ``stats`` tensor, the kernel counts the first
    two itself."""
    live = confmap_live_points(points, xv, yv, sigma)  # (B, tiles_y, tiles_x, I, N)
    th, tw = confmap_tile(points.shape[2])
    rows = torch.clamp(yv.shape[0] - th * torch.arange(live.shape[1], device=live.device), max=th)
    cols = torch.clamp(xv.shape[0] - tw * torch.arange(live.shape[2], device=live.device), max=tw)
    terms = int((live.sum(dim=(3, 4)) * (rows[:, None] * cols[None, :])).sum())
    tiles = live.any(dim=(3, 4))
    return int(tiles.sum()), terms, tiles.numel()


def _launch_multi_confmaps(points, xv, yv, out, sigma: float,
                           stats: Optional[torch.Tensor] = None) -> None:
    """Kernel 4's C entry on checked CUDA tensors, on the current stream.

    ``stats``: ``None``, or a zeroed ``(2,)`` int64 tensor on the points'
    device, to which the kernel adds the tiles that rendered a live point
    and the terms it computed (live points x the tile's pixels).
    """
    b, n_inst, n_nodes, _ = points.shape
    th, tw = confmap_tile(n_nodes)
    MULTI_CONFMAPS.launch(
        points.data_ptr(), xv.data_ptr(), yv.data_ptr(), out.data_ptr(),
        b, n_inst, n_nodes, yv.shape[0], xv.shape[0], tw.bit_length() - 1, th,
        min(n_inst, max(1, _CONFMAP_LIST // n_nodes)), float(2 * sigma**2), CONFMAP_CUTOFF,
        None if stats is None else stats.data_ptr(), torch.cuda.current_stream().cuda_stream,
    )
