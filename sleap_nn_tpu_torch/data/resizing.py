"""Resize / pad ops on channel-last image batches.

Port of ``sleap_nn_tpu/data/resizing.py``. Target sizes are Python ints
computed from the input shape, with the JAX package's rounding.

``jax.image.resize(method="bilinear")`` uses half-pixel centres and, when
it shrinks an axis, widens the triangle kernel by the inverse scale
(antialiasing) and renormalises it over the in-image taps.
``F.interpolate(mode="bilinear", align_corners=False)`` computes the same
weights once ``antialias=True`` is passed for a shrink (for an enlarged
axis the antialiased and plain paths coincide), so :func:`resize_bilinear`
turns antialiasing on exactly when an axis shrinks.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def resize_bilinear(image: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """``jax.image.resize(image, (..., height, width, C), "bilinear")``."""
    h, w, c = image.shape[-3:]
    if (h, w) == (height, width):
        return image
    lead = image.shape[:-3]
    x = image.reshape((-1, h, w, c)).permute(0, 3, 1, 2)
    y = F.interpolate(
        x, size=(height, width), mode="bilinear", align_corners=False,
        antialias=height < h or width < w,
    )
    return y.permute(0, 2, 3, 1).reshape(lead + (height, width, c))


def find_padding_for_stride(height: int, width: int, max_stride: int) -> Tuple[int, int]:
    """Bottom/right padding needed to make (height, width) divisible by stride."""
    pad_height = (max_stride - height % max_stride) % max_stride
    pad_width = (max_stride - width % max_stride) % max_stride
    return pad_height, pad_width


def apply_pad_to_stride(image: torch.Tensor, max_stride: int) -> torch.Tensor:
    """Zero-pad bottom/right to a multiple of ``max_stride`` (channel-last)."""
    h, w = image.shape[-3], image.shape[-2]
    pad_h, pad_w = find_padding_for_stride(h, w, max_stride)
    if pad_h == 0 and pad_w == 0:
        return image
    return F.pad(image, (0, 0, 0, pad_w, 0, pad_h))


def resize_image(image: torch.Tensor, scale: float) -> torch.Tensor:
    """Bilinear resize by a scale factor (channel-last, leading batch dims)."""
    h, w = image.shape[-3], image.shape[-2]
    return resize_bilinear(image, int(round(h * scale)), int(round(w * scale)))


def apply_resizer(image: torch.Tensor, instances: torch.Tensor, scale: float = 1.0):
    """Rescale image and ``(x, y)`` keypoints together."""
    if scale != 1.0:
        image = resize_image(image, scale)
        instances = instances * scale
    return image, instances


def apply_sizematcher(
    image: torch.Tensor,
    max_height: Optional[int] = None,
    max_width: Optional[int] = None,
) -> Tuple[torch.Tensor, float]:
    """Resize-to-fit (max_height, max_width) preserving aspect, then pad.

    Returns ``(image, eff_scale)``; keypoints must be multiplied by
    ``eff_scale``.
    """
    h, w = image.shape[-3], image.shape[-2]
    max_height = max_height or h
    max_width = max_width or w
    if h == max_height and w == max_width:
        return image, 1.0
    eff_scale = min(max_height / h, max_width / w)
    target_h = int(round(h * eff_scale))
    target_w = int(round(w * eff_scale))
    image = resize_bilinear(image, target_h, target_w)
    image = F.pad(image, (0, 0, 0, max_width - target_w, 0, max_height - target_h))
    return image, eff_scale
