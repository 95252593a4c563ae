"""Confidence-map target rendering.

Port of ``sleap_nn_tpu/ops/confmaps.py``. Confmaps are channel-last
``(..., H, W, n_nodes)`` f32. Multi-instance rendering is the port's
kernel 4: :func:`make_multi_confmaps` folds any leading axes into one batch
axis and calls :func:`sleap_nn_tpu_torch.ops.kernels.multi_confmaps`, where a
CUDA tensor runs ``csrc/multi_confmaps.cu`` and a CPU tensor the
broadcast-and-max of :func:`make_confmaps`.
"""

from __future__ import annotations

from typing import Tuple

import torch

from sleap_nn_tpu_torch.ops.grid import make_grid_vectors
from sleap_nn_tpu_torch.ops.kernels import make_confmaps, multi_confmaps

__all__ = ["make_confmaps", "make_multi_confmaps", "generate_confmaps",
           "generate_multiconfmaps"]


def make_multi_confmaps(
    points: torch.Tensor,
    xv: torch.Tensor,
    yv: torch.Tensor,
    sigma: float,
) -> torch.Tensor:
    """Multi-instance confmaps: the max over instances.

    ``points``: ``(..., n_instances, n_nodes, 2)``; NaN instances / nodes
    contribute zeros. Returns ``(..., H, W, n_nodes)``.
    """
    lead = points.shape[:-3]
    # The kernel takes dense inputs; a view (a node slice, a strided grid)
    # is copied first. ``reshape`` keeps a view where it can.
    out = multi_confmaps(points.reshape(-1, *points.shape[-3:]).contiguous(), xv.contiguous(),
                         yv.contiguous(), sigma)
    return out.reshape(*lead, *out.shape[1:])


def generate_confmaps(
    points: torch.Tensor,
    img_hw: Tuple[int, int],
    sigma: float = 1.5,
    output_stride: int = 2,
) -> torch.Tensor:
    """Single-instance confmaps at ``output_stride``; ``sigma`` is in input
    pixels (scaled by the stride here)."""
    height, width = img_hw
    xv, yv = make_grid_vectors(height, width, output_stride, device=points.device)
    return make_confmaps(points, xv, yv, sigma * output_stride)


def generate_multiconfmaps(
    points: torch.Tensor,
    img_hw: Tuple[int, int],
    sigma: float = 1.5,
    output_stride: int = 2,
    is_centroids: bool = False,
) -> torch.Tensor:
    """Multi-instance (or centroid) confmaps at ``output_stride``.

    For centroids the input is ``(..., n_instances, 2)`` and the output has
    one channel.
    """
    if is_centroids:
        points = points[..., None, :]  # (..., n_inst, 1, 2)
    height, width = img_hw
    xv, yv = make_grid_vectors(height, width, output_stride, device=points.device)
    return make_multi_confmaps(points, xv, yv, sigma * output_stride)
