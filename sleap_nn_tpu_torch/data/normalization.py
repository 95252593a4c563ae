"""Image normalization (port of ``sleap_nn_tpu/data/normalization.py``)."""

from __future__ import annotations

import torch

from sleap_nn_tpu_torch.models.model import rgb_to_grayscale


def normalize_image(image: torch.Tensor) -> torch.Tensor:
    """uint8 (or float) image -> float32 in [0, 1]."""
    if image.dtype == torch.uint8:
        return image.to(torch.float32) / 255.0
    return image.to(torch.float32)


def ensure_rgb(image: torch.Tensor) -> torch.Tensor:
    """Replicate single channel to 3 (channel-last)."""
    if image.shape[-1] == 1:
        return image.repeat_interleave(3, dim=-1)
    return image


def ensure_grayscale(image: torch.Tensor) -> torch.Tensor:
    """RGB -> single channel (channel-last)."""
    if image.shape[-1] == 3:
        return rgb_to_grayscale(image)
    return image


def apply_channel_config(image: torch.Tensor, ensure_rgb_flag: bool, ensure_gray_flag: bool):
    if ensure_rgb_flag:
        return ensure_rgb(image)
    if ensure_gray_flag:
        return ensure_grayscale(image)
    return image
