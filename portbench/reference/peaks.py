"""Plain PyTorch peak finding on channel-last confidence maps.

- A local peak is a cell strictly above its eight neighbours (cells outside
  the map count as -inf) and strictly above the threshold; a frame keeps
  its ``k`` highest, the lower flat index (row, column, channel) first
  among equal values.
- A global peak is a channel's highest cell, the first in row-major order
  among equal values; below the threshold it is no peak.
- Refinement: the offset of a peak cell is the mean of ``d`` over its
  ``patch x patch`` window, weighted by the map's values there (cells
  outside the map weigh 0; a window of zero mass gives offset 0).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def local_peak_mask(cms: torch.Tensor, threshold: float) -> torch.Tensor:
    """(B, H, W, C) maps -> bool mask of their local peaks."""
    v = cms.permute(0, 3, 1, 2).float()
    b, c, h, w = v.shape
    pad = F.pad(v, (1, 1, 1, 1), value=float("-inf"))
    neigh = torch.full_like(v, float("-inf"))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                neigh = torch.maximum(neigh, pad[:, :, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w])
    return ((v > neigh) & (v > threshold)).permute(0, 2, 3, 1)


def top_local_peaks(cms: torch.Tensor, threshold: float, k: int):
    """A frame's ``k`` highest local peaks: ``(xy (B, k, 2) long, vals (B, k),
    channels (B, k) long, valid (B, k) bool)``, highest first."""
    b, h, w, c = cms.shape
    scores = torch.where(local_peak_mask(cms, threshold), cms.float(),
                         torch.full_like(cms, float("-inf"), dtype=torch.float32))
    vals, idx = torch.sort(scores.reshape(b, -1), dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    valid = torch.isfinite(vals)
    y, rem = idx // (w * c), idx % (w * c)
    xy = torch.stack([rem // c, y], dim=-1)
    return xy, torch.where(valid, vals, torch.zeros_like(vals)), rem % c, valid


def global_peaks(cms: torch.Tensor, threshold: float):
    """Per (frame, channel): ``(xy (B, C, 2) long, vals (B, C), valid (B, C))``."""
    b, h, w, c = cms.shape
    flat = cms.float().reshape(b, h * w, c)
    vals, idx = flat.max(dim=1)  # first index among equal values
    xy = torch.stack([idx % w, idx // w], dim=-1)
    return xy, vals, vals >= threshold


def refine(maps: torch.Tensor, xy: torch.Tensor, patch: int = 5,
           rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Refined positions of integer cells ``xy`` (n, 2): cell ``i`` of map
    ``rows[i]`` of ``maps`` (m, H, W) (map ``i`` where ``rows`` is None),
    ``xy`` plus the weighted mean offset of its window."""
    m, h, w = maps.shape
    r = patch // 2
    pad = F.pad(maps.float(), (r, r, r, r))
    d = torch.arange(-r, r + 1, device=maps.device)
    ys = (xy[:, 1:2] + r + d[None]).clamp(0, h + 2 * r - 1)  # (n, patch)
    xs = (xy[:, 0:1] + r + d[None]).clamp(0, w + 2 * r - 1)
    rows = torch.arange(len(xy), device=maps.device) if rows is None else rows
    win = pad[rows[:, None, None], ys[:, :, None], xs[:, None, :]]
    z = win.sum(dim=(1, 2))
    safe = torch.where(z == 0, torch.ones_like(z), z)
    df = d.float()
    dx = (win * df[None, None, :]).sum(dim=(1, 2)) / safe
    dy = (win * df[None, :, None]).sum(dim=(1, 2)) / safe
    off = torch.stack([torch.where(z == 0, 0.0, dx), torch.where(z == 0, 0.0, dy)], dim=-1)
    return xy.float() + off


def nearest_cell(maps: torch.Tensor, p: torch.Tensor,
                 patch: int = 5) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each reported position ``p`` (n, 2) on map ``i`` of ``maps``, the
    cell within one cell of ``p`` rounded whose refined position lies
    nearest to it: ``(cells (n, 2) long, distance (n,) in map cells)``. A
    program reports refined positions only; this finds the cell it refined
    from."""
    _, h, w = maps.shape
    rows = torch.arange(len(p), device=p.device)
    d = torch.arange(-1, 2, device=p.device)
    offs = torch.stack(torch.meshgrid(d, d, indexing="xy"), dim=-1).reshape(-1, 2)
    raw = torch.round(p).long()[:, None, :] + offs[None]  # (n, k, 2)
    inside = (raw[..., 0] >= 0) & (raw[..., 0] < w) & (raw[..., 1] >= 0) & (raw[..., 1] < h)
    cells = torch.stack([raw[..., 0].clamp(0, w - 1), raw[..., 1].clamp(0, h - 1)], dim=-1)
    k = offs.shape[0]
    pos = refine(maps, cells.reshape(-1, 2), patch, rows.repeat_interleave(k))
    dist = (pos.reshape(cells.shape) - p[:, None, :].float()).norm(dim=-1)
    dist = torch.where(inside, dist, float("inf"))
    best = dist.argmin(dim=1)
    n = torch.arange(len(p), device=p.device)
    return cells[n, best], dist[n, best]


def values_at(maps: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """``maps`` (n, H, W) at integer cells ``xy`` (n, 2)."""
    return maps[torch.arange(len(xy), device=maps.device), xy[:, 1], xy[:, 0]].float()
