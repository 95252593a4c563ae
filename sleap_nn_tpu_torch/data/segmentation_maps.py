"""Segmentation training targets: foreground mask, centre heatmap, offsets.

Port of ``sleap_nn_tpu/data/segmentation_maps.py``. Masks are padded
stacks ``(B, I, H, W)`` with a validity mask ``(B, I)``; where labels
carry no masks, each instance's mask is drawn from its keypoints as
capsules around the skeleton's edges. The JAX package renders these with
plain jnp (no Pallas kernel), so this module is plain PyTorch; the leading
axes broadcast where the JAX package maps over them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from sleap_nn_tpu_torch.ops.edge_maps import distance_to_edge
from sleap_nn_tpu_torch.ops.grid import make_grid_vectors


def render_masks_from_instances(
    instances: torch.Tensor,
    img_hw: Tuple[int, int],
    edge_inds: Optional[torch.Tensor] = None,
    radius: float = 12.0,
) -> torch.Tensor:
    """Per-instance masks as capsules around skeleton edges.

    Pixels within ``radius`` of any edge segment (of any node where there
    are no edges) are foreground; a segment with a NaN end covers nothing.

    Args:
        instances: ``(..., n_instances, n_nodes, 2)`` NaN-padded keypoints.
        img_hw: mask resolution (full image pixels).
        edge_inds: ``(n_edges, 2)`` node indices, or None.

    Returns:
        ``(..., n_instances, H, W)`` bool.
    """
    h, w = img_hw
    xv, yv = make_grid_vectors(h, w, 1, device=instances.device)
    grid = torch.stack([xv[None, :].expand(h, -1), yv[:, None].expand(-1, w)], dim=-1)
    if edge_inds is not None and edge_inds.shape[0] > 0:
        src = instances[..., edge_inds[:, 0], :]
        dst = instances[..., edge_inds[:, 1], :]
    else:
        src = dst = instances
    # (..., I, 1, 1, E, 2) against the (H, W, 2) grid -> (..., I, H, W, E).
    d2 = distance_to_edge(grid, src[..., None, None, :, :], dst[..., None, None, :, :])
    d2 = torch.where(torch.isnan(d2), torch.full_like(d2, float("inf")), d2)
    return d2.amin(dim=-1) <= radius**2


def _area_downsample(mask: torch.Tensor, output_stride: int) -> torch.Tensor:
    """Area-average a ``(..., H, W)`` float mask by the stride."""
    if output_stride == 1:
        return mask
    *lead, h, w = mask.shape
    s = output_stride
    return mask.reshape(*lead, h // s, s, w // s, s).mean(dim=(-3, -1))


def generate_foreground_mask(
    masks: torch.Tensor,
    mask_valid: torch.Tensor,
    output_stride: int = 2,
    maxpool: bool = False,
) -> torch.Tensor:
    """Union foreground at the output stride, ``(B, H/s, W/s, 1)`` f32 in
    {0, 1}: a cell is foreground where more than half of it is covered
    (any of it with ``maxpool``)."""
    m = masks.float() * mask_valid[..., None, None]
    cov = _area_downsample(m.amax(dim=1), output_stride)
    thresh = 0.0 if maxpool else 0.5
    return (cov > thresh).float()[..., None]


def compute_mask_centroids(masks: torch.Tensor, mask_valid: torch.Tensor) -> torch.Tensor:
    """Centre of mass of each mask, ``(B, I, 2)`` (x, y) pixels; NaN for
    invalid or empty masks."""
    b, i, h, w = masks.shape
    m = masks.float()
    total = m.sum(dim=(-2, -1))
    xs = torch.arange(w, dtype=torch.float32, device=m.device)
    ys = torch.arange(h, dtype=torch.float32, device=m.device)
    denom = torch.clamp(total, min=1)
    cx = (m * xs).sum(dim=(-2, -1)) / denom
    cy = (m * ys[:, None]).sum(dim=(-2, -1)) / denom
    cents = torch.stack([cx, cy], dim=-1)
    ok = mask_valid & (total > 0)
    return torch.where(ok[..., None], cents, torch.full_like(cents, float("nan")))


def _cell_centres(n: int, output_stride: int, device) -> torch.Tensor:
    """Cell-centre coordinates ``i * s + s / 2`` of ``n`` output cells."""
    return torch.arange(n, dtype=torch.float32, device=device) * output_stride \
        + output_stride / 2.0


def generate_center_heatmap(
    masks: torch.Tensor,
    mask_valid: torch.Tensor,
    output_stride: int = 2,
    sigma: float = 4.0,
    centers: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Max-over-instances Gaussians at the mask centroids on the grid of
    cell centres, ``(B, H/s, W/s, 1)``; sigma is in output cells."""
    b, i, h, w = masks.shape
    if centers is None:
        centers = compute_mask_centroids(masks, mask_valid)
    xv = _cell_centres(w // output_stride, output_stride, masks.device)
    yv = _cell_centres(h // output_stride, output_stride, masks.device)
    s2 = 2 * (sigma * output_stride) ** 2
    cx = centers[..., 0][:, :, None, None]
    cy = centers[..., 1][:, :, None, None]
    g = torch.exp(-((xv - cx) ** 2 + (yv[:, None] - cy) ** 2) / s2)
    return torch.nan_to_num(g, nan=0.0).amax(dim=1)[..., None]


def generate_center_offsets(
    masks: torch.Tensor,
    mask_valid: torch.Tensor,
    output_stride: int = 2,
    centers: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cell ``(dx, dy)`` from the cell centre to its instance's centre.

    A cell belongs to each instance that covers more than half of it; where
    several do, the smallest (by pixel area) owns it. Returns ``(offsets
    (B, H/s, W/s, 2), weight (B, H/s, W/s, 1))``: zeros and weight 0 where
    no instance owns the cell.
    """
    b, i, h, w = masks.shape
    if centers is None:
        centers = compute_mask_centroids(masks, mask_valid)
    out_h, out_w = h // output_stride, w // output_stride
    m = masks.float() * mask_valid[..., None, None]
    m_ds = _area_downsample(m, output_stride) > 0.5  # (B, I, h', w')
    areas = masks.float().sum(dim=(-2, -1))
    inf = torch.full_like(areas, float("inf"))
    areas = torch.where(mask_valid, areas, inf)
    area_map = torch.where(m_ds, areas[..., None, None], float("inf"))
    owner = torch.argmin(area_map, dim=1)  # (B, h', w'); first minimum, as jnp
    covered = m_ds.any(dim=1)
    gx = _cell_centres(out_w, output_stride, masks.device)[None, :].expand(out_h, -1)
    gy = _cell_centres(out_h, output_stride, masks.device)[:, None].expand(-1, out_w)
    own = torch.gather(centers, 1, owner.reshape(b, -1, 1).expand(-1, -1, 2))
    own = own.reshape(b, out_h, out_w, 2)
    offsets = torch.stack([own[..., 0] - gx, own[..., 1] - gy], dim=-1)
    offsets = torch.where(covered[..., None], torch.nan_to_num(offsets, nan=0.0),
                          torch.zeros_like(offsets))
    return offsets, covered.float()[..., None]
