"""Tiled-inference blending: importance windows and the weighted merge.

Port of ``sleap_nn_tpu/inference/tile_merger.py`` as torch ops on the
tiles' device. The JAX merge is one XLA scatter-add whose indices are
clipped to the canvas, so the part of a tile past an edge piles onto the
canvas's first or last row or column; here each tile's rows and columns
are folded the same way (the overhang summed into the edge line) and the
folded tile is added into its slice of the canvas, tile by tile in grid
order. Sums run in another order than the scatter's, so results agree to
float rounding.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch


def build_importance_window(
    tile_hw: Tuple[int, int],
    mode: str = "gaussian",
    sigma_scale: float = 0.125,
    dtype=torch.float32,
    device="cpu",
) -> torch.Tensor:
    """Separable per-axis taper window, peak 1.0, floored at
    ``max(min, 1e-3)``."""
    th, tw = tile_hw
    if mode == "gaussian":
        sy, sx = sigma_scale * th, sigma_scale * tw
        y = np.arange(-(th - 1) / 2.0, (th - 1) / 2.0 + 1)
        x = np.arange(-(tw - 1) / 2.0, (tw - 1) / 2.0 + 1)
        gy = np.exp(y**2 / (-2 * sy**2))
        gx = np.exp(x**2 / (-2 * sx**2))
        w = gy[:, None] * gx[None, :]
    elif mode == "pyramid":
        iy = np.arange(1, th + 1, dtype=np.float32)
        ix = np.arange(1, tw + 1, dtype=np.float32)
        ry = np.minimum(iy, th + 1 - iy)
        rx = np.minimum(ix, tw + 1 - ix)
        w = (ry / ry.max())[:, None] * (rx / rx.max())[None, :]
    elif mode == "constant":
        w = np.ones((th, tw))
    else:
        raise ValueError(
            f"Unknown importance window mode: {mode!r}. "
            "Expected 'gaussian', 'pyramid', or 'constant'."
        )
    min_nz = max(float(w.min()), 1e-3)
    return torch.as_tensor(np.clip(w, min_nz, None), dtype=dtype, device=device)


def _fold(x: torch.Tensor, dim: int, origin: int, size: int):
    """``x`` placed at ``origin`` along ``dim`` of a canvas of ``size``,
    each index clipped to ``[0, size - 1]``: ``(start, folded)`` where the
    lines that clip onto the first or last canvas line are summed into it."""
    t = x.shape[dim]
    first = min(max(origin, 0), size - 1)
    last = min(max(origin + t - 1, 0), size - 1)
    if first == last:
        return first, x.sum(dim, keepdim=True)
    a = first - origin + 1  # lines 0..a-1 land on `first`
    b = last - origin  # lines b..t-1 land on `last`
    return first, torch.cat([x.narrow(dim, 0, a).sum(dim, keepdim=True), x.narrow(dim, a, b - a),
                             x.narrow(dim, b, t - b).sum(dim, keepdim=True)], dim)


def _add_tile(canvas: torch.Tensor, tile: torch.Tensor, y0: int, x0: int) -> None:
    """``canvas[clip(y0 + i), clip(x0 + j)] += tile[i, j]`` for ``(h, w, c)``
    canvases, in place."""
    h, w = canvas.shape[:2]
    ys, tile = _fold(tile, 0, y0, h)
    xs, tile = _fold(tile, 1, x0, w)
    canvas[ys:ys + tile.shape[0], xs:xs + tile.shape[1]] += tile


def merge_counts(origins: Sequence[Tuple[int, int]], canvas_hw: Tuple[int, int],
                 window: torch.Tensor, dtype=None) -> torch.Tensor:
    """``(H, W, 1)``: the summed window weights at each canvas pixel, the
    denominator of :func:`merge_tiles` (the same for every frame of a grid)."""
    cnt = torch.zeros((*canvas_hw, 1), dtype=dtype or window.dtype, device=window.device)
    for y0, x0 in origins:
        _add_tile(cnt, window[..., None], int(y0), int(x0))
    return cnt


def merge_tiles(
    tiles: torch.Tensor,
    origins,
    canvas_hw: Tuple[int, int],
    window: torch.Tensor,
    counts: torch.Tensor = None,
) -> torch.Tensor:
    """Blend per-tile maps back onto a canvas by weighted accumulation.

    Args:
        tiles: ``(n_tiles, th, tw, C)`` per-tile model outputs (output-stride
            resolution).
        origins: ``(n_tiles, 2)`` int ``(y0, x0)`` origins at the same
            resolution (a sequence or an integer array).
        canvas_hw: canvas size at the same resolution.
        window: ``(th, tw)`` importance weights.
        counts: :func:`merge_counts` of the same grid, if already made.

    Returns:
        ``(H, W, C)`` normalized merged map (``acc / max(cnt, 1e-8)``) in
        the tiles' dtype.
    """
    origins = [(int(y), int(x)) for y, x in np.asarray(origins, np.int64).reshape(-1, 2)]
    acc = torch.zeros((*canvas_hw, tiles.shape[-1]), dtype=tiles.dtype, device=tiles.device)
    weighted = tiles * window[None, :, :, None]
    for i, (y0, x0) in enumerate(origins):
        _add_tile(acc, weighted[i], y0, x0)
    if counts is None:
        counts = merge_counts(origins, canvas_hw, window, tiles.dtype)
    return acc / torch.clamp(counts.to(tiles.dtype), min=1e-8)
