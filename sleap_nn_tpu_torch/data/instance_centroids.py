"""Instance centroids (port of ``sleap_nn_tpu/data/instance_centroids.py``)."""

from __future__ import annotations

from typing import Optional

import torch


def find_points_mean(points: torch.Tensor) -> torch.Tensor:
    """NaN-aware mean over the node axis: ``(..., n_nodes, 2) -> (..., 2)``;
    NaN where no node is visible."""
    valid = ~torch.isnan(points[..., 0:1])
    filled = torch.nan_to_num(points)
    count = valid.sum(dim=-2)
    total = (filled * valid).sum(dim=-2)
    mean = total / torch.clamp(count, min=1)
    return torch.where(count > 0, mean, torch.full_like(mean, float("nan")))


def generate_centroids(
    instances: torch.Tensor, anchor_ind: Optional[int] = None
) -> torch.Tensor:
    """Centroid per instance: the anchor node if visible, else the mean of the
    visible nodes. ``(..., n_instances, n_nodes, 2) -> (..., n_instances, 2)``."""
    mean = find_points_mean(instances)
    if anchor_ind is None:
        return mean
    anchor = instances[..., anchor_ind, :]
    use_anchor = ~torch.isnan(anchor[..., 0:1])
    return torch.where(use_anchor, anchor, mean)
