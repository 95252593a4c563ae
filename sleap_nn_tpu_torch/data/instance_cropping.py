"""Instance crop-size computation and crop generation.

Port of ``sleap_nn_tpu/data/instance_cropping.py``: the crop-size helpers
are the JAX module's host-side numpy, copied; :func:`generate_crops`
gathers with the port's :func:`~sleap_nn_tpu_torch.ops.crops.crop_bboxes`.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from sleap_nn_tpu_torch.io.model import Labels
from sleap_nn_tpu_torch.ops.crops import crop_bboxes, make_centered_bboxes


def compute_augmentation_padding(
    bbox_size: float, rotation_max: float = 0.0, scale_max: float = 1.0
) -> int:
    """Padding that keeps an instance inside its crop under rotation and scale augmentation."""
    if rotation_max == 0.0 and scale_max <= 1.0:
        return 0
    rotation_rad = math.radians(min(abs(rotation_max), 90))
    rotation_factor = abs(math.cos(rotation_rad)) + abs(math.sin(rotation_rad))
    if abs(rotation_max) >= 45:
        rotation_factor = math.sqrt(2)
    expansion = rotation_factor * max(scale_max, 1.0)
    return int(math.ceil(bbox_size * expansion - bbox_size))


def find_max_instance_bbox_size(labels: Labels) -> float:
    """The largest bbox side over all non-empty instances."""
    max_length = 0.0
    for lf in labels:
        for inst in lf.instances:
            if inst.is_empty():
                continue
            pts = inst.numpy()
            dx = np.nanmax(pts[:, 0]) - np.nanmin(pts[:, 0])
            dy = np.nanmax(pts[:, 1]) - np.nanmin(pts[:, 1])
            max_length = max(max_length, 0 if np.isnan(dx) else dx, 0 if np.isnan(dy) else dy)
    return float(max_length)


def find_instance_crop_size(
    labels: Labels,
    padding: int = 0,
    maximum_stride: int = 2,
    min_crop_size: Optional[int] = None,
) -> int:
    """A crop size that covers the largest instance, rounded up to ``maximum_stride``."""
    min_crop_size = 0 if min_crop_size is None else min_crop_size
    if min_crop_size > 0 and min_crop_size % maximum_stride == 0:
        return min_crop_size
    max_length = max(find_max_instance_bbox_size(labels), float(min_crop_size - padding))
    max_length += float(padding)
    return int(math.ceil(max_length / float(maximum_stride)) * maximum_stride)


def generate_crops(
    image: torch.Tensor,
    instances: torch.Tensor,
    centroids: torch.Tensor,
    crop_size: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Crop around centroids and shift keypoints into crop coordinates.

    Args:
        image: ``(B, H, W, C)``.
        instances: ``(B, ..., n_nodes, 2)`` keypoints, one entry per crop.
        centroids: ``(B, 2)`` crop centers, one crop per batch row.
        crop_size: the crop's side.

    Returns:
        ``(crops (B, crop, crop, C), shifted instances, shifted centroids)``.
        The shift is the crop's truncated top-left, the start that
        ``crop_bboxes`` gathers from (NaN for a NaN centroid).
    """
    bboxes = make_centered_bboxes(centroids, crop_size, crop_size)
    crops = crop_bboxes(image, bboxes, torch.arange(image.shape[0], device=image.device),
                        crop_size, crop_size)
    half = float(crop_size // 2)
    top_left = torch.trunc(bboxes[:, 0, :] + half) - half
    shift = top_left.reshape((image.shape[0],) + (1,) * (instances.ndim - 2) + (2,))
    return crops, instances - shift, centroids - top_left
