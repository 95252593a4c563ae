"""Batched bbox construction and crop extraction.

Port of ``sleap_nn_tpu/ops/crops.py``. The JAX package zero-pads the
images by one crop size on every side and takes one ``lax.dynamic_slice``
per crop; this port gathers straight from the unpadded images with the
same start indices (including how ``dynamic_slice`` wraps a negative
start and clamps an out-of-range one) and writes zeros where a crop
leaves the image.
"""

from __future__ import annotations

import torch


def make_centered_bboxes(
    centroids: torch.Tensor, box_height: int, box_width: int
) -> torch.Tensor:
    """Corner bboxes centered on points.

    Args:
        centroids: ``(..., 2)`` (x, y) centers.

    Returns:
        ``(..., 4, 2)`` corners in top-left, top-right, bottom-right,
        bottom-left order (a box of size k spans ``center +- (k - 1) / 2``).
    """
    half_h = (box_height - 1) / 2.0
    half_w = (box_width - 1) / 2.0
    x, y = centroids[..., 0], centroids[..., 1]
    return torch.stack(
        [
            torch.stack([x - half_w, y - half_h], dim=-1),
            torch.stack([x + half_w, y - half_h], dim=-1),
            torch.stack([x + half_w, y + half_h], dim=-1),
            torch.stack([x - half_w, y + half_h], dim=-1),
        ],
        dim=-2,
    )


def _dynamic_slice_start(start: torch.Tensor, dim: int, size: int) -> torch.Tensor:
    """Start index as ``lax.dynamic_slice`` takes it: a negative start counts
    from the end (``start + dim``), then the start is clamped to
    ``[0, dim - size]``."""
    return torch.where(start < 0, start + dim, start).clamp(0, dim - size)


def crop_bboxes(
    images: torch.Tensor,
    bboxes: torch.Tensor,
    sample_inds: torch.Tensor,
    crop_height: int,
    crop_width: int,
) -> torch.Tensor:
    """Extract fixed-size crops at bbox top-lefts; outside pixels are 0.

    NaN bbox coordinates produce an all-zero crop (padded / invalid peaks).

    Args:
        images: ``(samples, H, W, C)``.
        bboxes: ``(n_bboxes, 4, 2)`` corners from :func:`make_centered_bboxes`.
        sample_inds: ``(n_bboxes,)`` int, source sample per crop.

    Returns:
        ``(n_bboxes, crop_height, crop_width, C)``.
    """
    n_img, h, w = images.shape[0], images.shape[1], images.shape[2]
    dev = images.device
    top_left = bboxes[:, 0, :]  # (n, 2) (x, y)
    invalid = torch.isnan(top_left).any(dim=-1)
    # The reference's legacy floor, trunc(x + half) - half; invalid crops
    # start at the corner of the zero padding. Python scalars, not tensors
    # made on the host: copying one to the card would wait for its stream.
    start = []
    for i, size, dim in ((1, crop_height, h), (0, crop_width, w)):
        corner = torch.trunc(torch.nan_to_num(top_left[:, i]) + size // 2).long() - size // 2
        corner = torch.where(invalid, -size, corner)
        start.append(_dynamic_slice_start(corner + size, dim + 2 * size, size))
    start_y, start_x = start
    ys = start_y[:, None] - crop_height + torch.arange(crop_height, device=dev)
    xs = start_x[:, None] - crop_width + torch.arange(crop_width, device=dev)
    inside = (((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :])
    s = _dynamic_slice_start(sample_inds.long(), n_img, 1)
    crops = images[s[:, None, None], ys.clamp(0, h - 1)[:, :, None], xs.clamp(0, w - 1)[:, None, :]]
    return torch.where(inside[..., None], crops, torch.zeros((), dtype=crops.dtype, device=dev))
