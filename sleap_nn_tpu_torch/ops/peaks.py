"""Peak finding on confidence maps (NMS + integral sub-pixel refinement).

Port of ``sleap_nn_tpu/ops/peaks.py``, with its contract: channel-last
``(B, H, W, C)`` maps; :func:`find_local_peaks` returns fixed-size
per-sample top-K arrays plus a validity mask; invalid peaks flow through
as NaN and are masked, never dropped, so no step waits on the host.

The local-peak score map comes from the ``nms_scores`` kernel
(``ops/kernels.py``). The top-K keeps ``jax.lax.top_k``'s order: value
descending, lower flat index first among equal values (a stable sort;
``torch.topk`` promises no order among ties).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from sleap_nn_tpu_torch.ops.crops import crop_bboxes, make_centered_bboxes
from sleap_nn_tpu_torch.ops.kernels import nms_scores


def nms_max_pool(cms: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Max over the ``kernel x kernel`` neighborhood (center excluded).

    Args:
        cms: ``(..., H, W, C)``.

    Returns:
        Same shape; ``cms > nms_max_pool(cms)`` marks strict local maxima.
        Cells outside the map count as -inf; a NaN neighbour propagates.
    """
    if kernel % 2 != 1 or kernel < 3:
        raise ValueError(f"NMS kernel must be an odd int >= 3, got {kernel}")
    r = kernel // 2
    p = F.pad(cms, (0, 0, r, r, r, r), value=float("-inf"))
    h, w = cms.shape[-3], cms.shape[-2]
    out = None
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dy == 0 and dx == 0:
                continue  # strict maxima: exclude the center itself
            s = p[..., r + dy: r + dy + h, r + dx: r + dx + w, :]
            out = s if out is None else torch.maximum(out, s)
    return out


def integral_regression(
    crops: torch.Tensor, xv: torch.Tensor, yv: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expected (x, y) under the crop's mass.

    Args:
        crops: ``(n, h, w)`` or ``(n, h, w, 1)`` patches.
        xv / yv: coordinate vectors of length w / h.

    Returns:
        ``(x_hat, y_hat)`` each ``(n,)``; all-zero crops give 0 offsets.
    """
    if crops.ndim == 4:
        crops = crops[..., 0]
    z = crops.sum(dim=(1, 2))
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    x_hat = (xv[None, None, :] * crops).sum(dim=(1, 2)) / safe_z
    y_hat = (yv[None, :, None] * crops).sum(dim=(1, 2)) / safe_z
    x_hat = torch.where(z == 0, torch.zeros_like(x_hat), x_hat)
    y_hat = torch.where(z == 0, torch.zeros_like(y_hat), y_hat)
    return x_hat, y_hat


def find_global_peaks_rough(
    cms: torch.Tensor, threshold: float = 0.1
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global max per (sample, channel); the first index wins a tie.

    Returns ``(points (B, C, 2) (x, y) f32, NaN below threshold; vals (B, C),
    0 below threshold)``.
    """
    b, h, w, c = cms.shape
    flat = cms.reshape(b, h * w, c)
    idx = flat.argmax(dim=1)
    vals = flat.amax(dim=1)
    points = torch.stack([idx % w, idx // w], dim=-1).to(torch.float32)
    below = vals < threshold
    points = torch.where(below[..., None], torch.full_like(points, float("nan")), points)
    vals = torch.where(below, torch.zeros_like(vals), vals)
    return points, vals


def refine_peaks_integral(
    cms: torch.Tensor,
    rough_peaks: torch.Tensor,
    sample_inds: torch.Tensor,
    channel_inds: torch.Tensor,
    integral_patch_size: int = 5,
) -> torch.Tensor:
    """Integral sub-pixel refinement of rough ``(n, 2)`` peaks (NaN rows pass)."""
    b, h, w, c = cms.shape
    patch = integral_patch_size
    maps = cms.permute(0, 3, 1, 2).reshape(b * c, h, w, 1)
    flat_inds = sample_inds.long() * c + channel_inds.long()
    bboxes = make_centered_bboxes(rough_peaks, patch, patch)
    crops = crop_bboxes(maps, bboxes, flat_inds, patch, patch)
    gv = torch.arange(patch, dtype=torch.float32, device=cms.device) - (patch - 1) / 2.0
    dx, dy = integral_regression(crops, gv, gv)
    return rough_peaks + torch.stack([dx, dy], dim=-1)


def refine_global_peaks_windowed(
    cms: torch.Tensor, rough: torch.Tensor, integral_patch_size: int = 5
) -> torch.Tensor:
    """Integral refinement of one-peak-per-channel rough peaks, gather-free.

    Rough peaks are snapped to the pixel grid first; the patch sum is a
    distance window against the snapped peak; out-of-image cells
    contribute zero; a zero-mass window gives a zero offset.

    Args:
        cms: ``(B, H, W, C)``.
        rough: ``(B, C, 2)`` (x, y); NaN rows pass through.

    Returns:
        ``(B, C, 2)`` refined peaks.
    """
    b, h, w, c = cms.shape
    rough = torch.round(rough)  # NaN passes through
    r = (integral_patch_size - 1) / 2.0
    f = cms.to(torch.float32)
    xs = torch.arange(w, dtype=torch.float32, device=cms.device)[None, None, :, None]
    ys = torch.arange(h, dtype=torch.float32, device=cms.device)[None, :, None, None]
    dist_x = xs - rough[..., 0][:, None, None, :]
    dist_y = ys - rough[..., 1][:, None, None, :]
    win = (dist_x.abs() <= r) & (dist_y.abs() <= r)  # False for NaN
    v = torch.where(win, f, torch.zeros((), device=cms.device))
    z = v.sum(dim=(1, 2))
    safe_z = torch.where(z == 0, torch.ones_like(z), z)
    dx = (v * dist_x).sum(dim=(1, 2)) / safe_z
    dy = (v * dist_y).sum(dim=(1, 2)) / safe_z
    dx = torch.where(z == 0, torch.zeros_like(dx), dx)
    dy = torch.where(z == 0, torch.zeros_like(dy), dy)
    return rough + torch.stack([dx, dy], dim=-1)


def find_global_peaks(
    cms: torch.Tensor,
    threshold: float = 0.2,
    refinement: Optional[str] = None,
    integral_patch_size: int = 5,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Global peaks with optional integral refinement.

    Returns ``(points (B, C, 2), vals (B, C))``, NaN points below threshold.
    """
    points, vals = find_global_peaks_rough(cms, threshold=threshold)
    if refinement != "integral":
        return points, vals
    return refine_global_peaks_windowed(cms, points, integral_patch_size), vals


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k`` over the last axis: descending, lower index first on ties."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def find_local_peaks_rough(
    cms: torch.Tensor, threshold: float = 0.2, max_peaks: int = 100,
    nms_kernel: int = 3,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local-maximum peaks, fixed-size top-K per sample.

    A pixel is a peak when it strictly exceeds its neighbourhood max and
    the threshold; per sample the ``max_peaks`` highest peaks are kept.

    Returns:
        ``(points, vals, channel_inds, valid)``: points ``(B, K, 2)`` (x, y)
        f32, NaN on invalid slots; vals ``(B, K)`` f32 (0 on invalid);
        channel_inds ``(B, K)`` int32 (-1 invalid); valid ``(B, K)`` bool.
        Sorted by value descending.
    """
    b, h, w, c = cms.shape
    scores = nms_scores(cms.contiguous(), threshold, kernel=nms_kernel).reshape(b, h * w * c)
    k = min(max_peaks, h * w * c)
    top_vals, top_idx = top_k(scores, k)
    valid = torch.isfinite(top_vals)
    yy = top_idx // (w * c)
    rem = top_idx % (w * c)
    points = torch.stack([rem // c, yy], dim=-1).to(torch.float32)
    points = torch.where(valid[..., None], points, torch.full_like(points, float("nan")))
    vals = torch.where(valid, top_vals, torch.zeros_like(top_vals))
    channel_inds = torch.where(valid, rem % c, torch.full_like(rem, -1)).to(torch.int32)
    if k < max_peaks:
        padn = max_peaks - k
        points = F.pad(points, (0, 0, 0, padn), value=float("nan"))
        vals = F.pad(vals, (0, padn))
        channel_inds = F.pad(channel_inds, (0, padn), value=-1)
        valid = F.pad(valid, (0, padn))
    return points, vals, channel_inds, valid


def find_local_peaks(
    cms: torch.Tensor,
    threshold: float = 0.2,
    refinement: Optional[str] = None,
    integral_patch_size: int = 5,
    max_peaks: int = 100,
    return_rough: bool = False,
    nms_kernel: int = 3,
) -> Tuple[torch.Tensor, ...]:
    """Local peaks with optional integral refinement (fixed-size contract).

    Same returns as :func:`find_local_peaks_rough`; with ``return_rough``
    a fifth array holds the unrefined integer peak positions.
    """
    points, vals, channel_inds, valid = find_local_peaks_rough(
        cms, threshold=threshold, max_peaks=max_peaks, nms_kernel=nms_kernel
    )
    rough = points
    if refinement == "integral":
        b, k = points.shape[:2]
        sample_inds = torch.arange(b, device=cms.device).repeat_interleave(k)
        refined = refine_peaks_integral(
            cms, points.reshape(b * k, 2), sample_inds,
            channel_inds.reshape(b * k).clamp(min=0), integral_patch_size,
        ).reshape(b, k, 2)
        points = torch.where(valid[..., None], refined, torch.full_like(refined, float("nan")))
    if return_rough:
        return points, vals, channel_inds, valid, rough
    return points, vals, channel_inds, valid
