"""Architecture math: receptive fields, stride sizing, crop and tile sizes.

Port of ``sleap_nn_tpu/config_generator/architecture_estimates.py``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple


SUPPORTED_MAX_STRIDES: Tuple[int, ...] = (8, 16, 32, 64, 128)


def encoder_blocks(max_stride: int) -> int:
    return int(math.log2(max_stride))


def decoder_blocks(max_stride: int, output_stride: int) -> int:
    if not output_stride:
        # output_stride=0/None -> full-resolution decoder (reference: :66).
        return encoder_blocks(max_stride)
    return int(math.log2(max_stride / output_stride))


def compute_receptive_field(
    max_stride: int, convs_per_block: int = 2, kernel_size: int = 3
) -> int:
    """Theoretical receptive field of the deepest UNet encoder layer.

    Each encoder level has ``convs_per_block`` kxk stride-1 convs followed
    by a 2x2 stride-2 pool; the canonical layer-by-layer formula
    ``RF = 1 + sum((kernel[l]-1) * prod(strides[:l]))`` gives
    36/76/156/316/636 for max_stride 8/16/32/64/128
    (reference: architecture_estimates.py:23, the web app's RF_TABLE).
    """
    down = int(math.log2(max_stride)) if max_stride > 0 else -1
    if max_stride < 2 or 2**down != max_stride:
        raise ValueError(
            f"max_stride must be a power of 2 >= 2, got {max_stride}."
        )
    rf = 1
    stride = 1
    for _ in range(down):
        rf += convs_per_block * (kernel_size - 1) * stride  # convs
        rf += stride  # 2x2 stride-2 pool: (2 - 1) * current stride
        stride *= 2
    return rf


def compute_max_stride_for_animal_size(
    animal_size: float,
    candidates: Tuple[int, ...] = SUPPORTED_MAX_STRIDES,
    convs_per_block: int = 2,
    kernel_size: int = 3,
) -> int:
    """Smallest candidate max_stride whose RF covers the animal (reference: :75).

    Falls back to the largest candidate when none covers it.
    """
    for max_stride in sorted(candidates):
        if compute_receptive_field(max_stride, convs_per_block, kernel_size) >= animal_size:
            return max_stride
    return max(candidates)


def recommend_default_max_stride(avg_animal_size: float, scale: float = 1.0) -> int:
    """Bucketed default max_stride from the scaled animal size (reference: :96).

    Web-app bucket boundaries: effective size < 40 -> 8, > 100 -> 32,
    else 16 (reference config-picker ``setDefaultParameters``).
    """
    size = avg_animal_size * scale
    if size < 40:
        return 8
    if size > 100:
        return 32
    return 16


def estimate_unet_params(
    filters: int = 32,
    filters_rate: float = 1.5,
    max_stride: int = 16,
    output_stride: int = 2,
    convs_per_block: int = 2,
    kernel_size: int = 3,
    in_channels: int = 1,
    head_channels: int = 1,
) -> int:
    """Analytic UNet parameter count (the model the UNet config builds)."""
    k2 = kernel_size * kernel_size
    total = 0
    down = encoder_blocks(max_stride)
    prev = in_channels
    for block in range(down):
        f = int(filters * (filters_rate**block))
        for i in range(convs_per_block):
            cin = prev if i == 0 else f
            total += cin * f * k2 + f
        prev = f
    # middle expand + contract
    mid = int(filters * (filters_rate**down))
    for i in range(max(convs_per_block - 1, 0)):
        cin = prev if i == 0 else mid
        total += cin * mid * k2 + mid
        prev = mid
    total += prev * mid * k2 + mid
    prev = mid
    # decoder
    up = decoder_blocks(max_stride, output_stride)
    for block in range(up):
        f = int(filters * (filters_rate ** max(0, down - 1 - block)))
        skip = int(filters * (filters_rate ** max(0, down - 1 - block)))
        for i in range(convs_per_block):
            cin = (prev + skip) if i == 0 else f
            total += cin * f * k2 + f
        prev = f
    total += prev * head_channels + head_channels  # 1x1 head
    return total


def compute_augmentation_padding(
    bbox_size: float, rotation_max: float = 0.0, scale_max: float = 1.0
) -> int:
    from sleap_nn_tpu_torch.data.instance_cropping import compute_augmentation_padding as f

    return f(bbox_size, rotation_max, scale_max)


def compute_suggested_crop_size(
    max_bbox_size: float,
    max_stride: int,
    rotation_max: float = 0.0,
    scale_max: float = 1.0,
    min_crop_size: int = 0,
) -> int:
    """Crop size covering the largest instance + augmentation expansion."""
    pad = compute_augmentation_padding(max_bbox_size, rotation_max, scale_max)
    size = max(max_bbox_size + pad, min_crop_size)
    return int(math.ceil(size / max_stride) * max_stride)


def compute_pad_to_stride(height: int, width: int, max_stride: int) -> Tuple[int, int]:
    from sleap_nn_tpu_torch.data.resizing import find_padding_for_stride

    ph, pw = find_padding_for_stride(height, width, max_stride)
    return height + ph, width + pw


def compute_backbone_context_margin(
    max_stride: int, convs_per_block: int = 2, kernel_size: int = 3
) -> int:
    """Half the receptive field: context a prediction needs around a point."""
    return compute_receptive_field(max_stride, convs_per_block, kernel_size) // 2


def compute_suggested_tile_size(
    avg_bbox_size: float,
    max_stride: int,
    output_stride: int,
    sigma: float = 5.0,
    min_tile: int = 128,
    max_tile: int = 1024,
) -> int:
    """Tile size: a few animal diameters + context margin, stride-aligned
    (reference: :312; used by trainer tiling auto-size)."""
    margin = compute_backbone_context_margin(max_stride)
    size = max(2.5 * avg_bbox_size + 2 * margin, min_tile)
    size = min(size, max_tile)
    unit = max(max_stride, output_stride)
    return int(math.ceil(size / unit) * unit)


def compute_suggested_tile_overlap(
    avg_bbox_size: float,
    max_stride: int,
    sigma: float = 5.0,
    tile_size: Optional[int] = None,
) -> int:
    """Overlap: one animal + confmap spread + context margin (reference: :344)."""
    margin = compute_backbone_context_margin(max_stride)
    overlap = int(math.ceil(avg_bbox_size + 4 * sigma + margin))
    if tile_size is not None:
        overlap = min(overlap, tile_size // 2)
    return overlap
