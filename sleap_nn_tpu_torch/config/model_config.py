"""Model config schema for the ported models (copied from the JAX package's
``config/model_config.py``: the UNet backbone and the centroid /
centered-instance heads, the configs the top-down path needs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional


@dataclass
class UNetConfig:
    in_channels: int = 1
    kernel_size: int = 3
    filters: int = 32
    filters_rate: float = 1.5
    max_stride: int = 16
    stem_stride: Optional[int] = None
    middle_block: bool = True
    up_interpolate: bool = True
    stacks: int = 1
    convs_per_block: int = 2
    output_stride: int = 1
    # Transposed-conv phase convention: "torch" (reference-aligned, default)
    # or "tf" (legacy SLEAP v1 Keras imports). See encoder_decoder.py.
    trans_conv_phase: Optional[str] = None


@dataclass
class UNetMediumRFConfig(UNetConfig):
    filters: int = 24
    max_stride: int = 32


@dataclass
class CentroidConfMapsConfig:
    anchor_part: Optional[str] = None
    centroid_source: Optional[str] = None
    sigma: float = 5.0
    output_stride: int = 1


@dataclass
class CenteredInstanceConfMapsConfig:
    part_names: Optional[List[str]] = None
    anchor_part: Optional[str] = None
    sigma: float = 5.0
    output_stride: int = 1
    loss_weight: float = 1.0


@dataclass
class CentroidConfig:
    confmaps: Optional[CentroidConfMapsConfig] = None


@dataclass
class CenteredInstanceConfig:
    confmaps: Optional[CenteredInstanceConfMapsConfig] = None
