"""Sampling-grid helpers (port of ``sleap_nn_tpu/ops/grid.py``)."""

from __future__ import annotations

from typing import Tuple

import torch


def make_grid_vectors(
    image_height: int, image_width: int, output_stride: int = 1, device=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sampling grid vectors ``(xv, yv)``: ``0, stride, 2*stride, ...`` (f32)."""
    xv = torch.arange(0, image_width, output_stride, dtype=torch.float32, device=device)
    yv = torch.arange(0, image_height, output_stride, dtype=torch.float32, device=device)
    return xv, yv


def gaussian_pdf(x: torch.Tensor, sigma: float) -> torch.Tensor:
    """Unnormalized 0-centered Gaussian PDF: ``exp(-x^2 / (2 sigma^2))``."""
    return torch.exp(-(x**2) / (2 * sigma**2))
