"""Model config schema: a copy of ``sleap_nn_tpu/config/model_config.py``
(plain data; the port builds the UNet backbone and the single-instance,
centroid, centered-instance and bottom-up heads from it)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


# ---------------------------------------------------------------------------
# Backbones
# ---------------------------------------------------------------------------


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
class UNetLargeRFConfig(UNetConfig):
    filters: int = 32
    filters_rate: float = 2.0
    max_stride: int = 16


@dataclass
class ConvNextConfig:
    model_type: str = "tiny"  # tiny | small | base | large
    arch: Optional[dict] = None
    stem_patch_kernel: int = 4
    stem_patch_stride: int = 2
    in_channels: int = 1
    kernel_size: int = 3
    filters_rate: float = 2.0
    convs_per_block: int = 2
    up_interpolate: bool = True
    output_stride: int = 1
    max_stride: int = 32


@dataclass
class SwinTConfig:
    model_type: str = "tiny"  # tiny | small | base
    arch: Optional[dict] = None
    max_stride: int = 32
    patch_size: int = 4
    stem_patch_stride: int = 2
    window_size: int = 7
    in_channels: int = 1
    kernel_size: int = 3
    filters_rate: float = 2.0
    convs_per_block: int = 2
    up_interpolate: bool = True
    output_stride: int = 1


@dataclass
class PretrainedConfig:
    source: str = "hf"
    model_name: str = "facebook/convnextv2-nano-22k-224"
    weights: bool = True
    mode: str = "auto"
    freeze: bool = False
    revision: Optional[str] = None
    normalize: bool = True
    image_mean: Optional[List[float]] = None
    image_std: Optional[List[float]] = None
    out_indices: Optional[List[int]] = None
    in_channels: int = 3
    filters_rate: float = 2.0
    convs_per_block: int = 2
    kernel_size: int = 3
    up_interpolate: bool = True
    output_stride: int = 2
    max_stride: int = 32


@dataclass
class BackboneConfig:
    unet: Optional[UNetConfig] = None
    convnext: Optional[ConvNextConfig] = None
    swint: Optional[SwinTConfig] = None
    pretrained: Optional[PretrainedConfig] = None

    def which(self) -> str:
        """Return the name of the (single) set backbone."""
        set_ones = [
            k for k in ("unet", "convnext", "swint", "pretrained") if getattr(self, k) is not None
        ]
        if len(set_ones) != 1:
            raise ValueError(
                f"Exactly one backbone must be set; found: {set_ones or 'none'}."
            )
        return set_ones[0]


# ---------------------------------------------------------------------------
# Heads
# ---------------------------------------------------------------------------


@dataclass
class SingleInstanceConfMapsConfig:
    part_names: Optional[List[str]] = None
    sigma: float = 5.0
    output_stride: int = 1


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
class BottomUpConfMapsConfig:
    part_names: Optional[List[str]] = None
    sigma: float = 5.0
    output_stride: int = 1
    loss_weight: Optional[float] = None


@dataclass
class PAFConfig:
    edges: Optional[List[List[str]]] = None
    sigma: float = 15.0
    output_stride: int = 1
    loss_weight: Optional[float] = None


@dataclass
class ClassMapConfig:
    classes: Optional[List[str]] = None
    sigma: float = 5.0
    output_stride: int = 1
    loss_weight: Optional[float] = None


@dataclass
class ClassVectorsConfig:
    classes: Optional[List[str]] = None
    num_fc_layers: int = 1
    num_fc_units: int = 64
    global_pool: bool = True
    output_stride: int = 1
    loss_weight: float = 1.0


@dataclass
class SegmentationHeadConfig:
    output_stride: int = 2
    loss_weight: float = 1.0
    bce_weight: float = 0.5
    dice_weight: float = 0.5
    bce_pos_weight: Optional[float] = None
    target_maxpool: bool = False


@dataclass
class InstanceCenterConfig:
    sigma: float = 4.0
    output_stride: int = 2
    loss_weight: float = 1.0


@dataclass
class CenterOffsetConfig:
    output_stride: int = 2
    loss_weight: float = 0.1


@dataclass
class SingleInstanceConfig:
    confmaps: Optional[SingleInstanceConfMapsConfig] = None


@dataclass
class CentroidConfig:
    confmaps: Optional[CentroidConfMapsConfig] = None


@dataclass
class CenteredInstanceConfig:
    confmaps: Optional[CenteredInstanceConfMapsConfig] = None


@dataclass
class BottomUpConfig:
    confmaps: Optional[BottomUpConfMapsConfig] = None
    pafs: Optional[PAFConfig] = None


@dataclass
class BottomUpMultiClassConfig:
    confmaps: Optional[BottomUpConfMapsConfig] = None
    class_maps: Optional[ClassMapConfig] = None


@dataclass
class TopDownCenteredInstanceMultiClassConfig:
    confmaps: Optional[CenteredInstanceConfMapsConfig] = None
    class_vectors: Optional[ClassVectorsConfig] = None


@dataclass
class BottomUpSegmentationConfig:
    segmentation: Optional[SegmentationHeadConfig] = None
    center: Optional[InstanceCenterConfig] = None
    offsets: Optional[CenterOffsetConfig] = None


@dataclass
class CenteredInstanceSegmentationHeadConfig:
    output_stride: int = 2
    loss_weight: float = 1.0
    anchor_part: Optional[str] = None


@dataclass
class CenteredInstanceSegmentationConfig:
    segmentation: Optional[CenteredInstanceSegmentationHeadConfig] = None


@dataclass
class SemanticSegmentationConfig:
    segmentation: Optional[SegmentationHeadConfig] = None


@dataclass
class HeadConfig:
    """Oneof wrapper: exactly one model-type leaf set (reference: model_config.py:979+)."""

    single_instance: Optional[SingleInstanceConfig] = None
    centroid: Optional[CentroidConfig] = None
    centered_instance: Optional[CenteredInstanceConfig] = None
    bottomup: Optional[BottomUpConfig] = None
    multi_class_bottomup: Optional[BottomUpMultiClassConfig] = None
    multi_class_topdown: Optional[TopDownCenteredInstanceMultiClassConfig] = None
    bottomup_segmentation: Optional[BottomUpSegmentationConfig] = None
    centered_instance_segmentation: Optional[CenteredInstanceSegmentationConfig] = None
    semantic_segmentation: Optional[SemanticSegmentationConfig] = None

    def which(self) -> str:
        set_ones = [
            k
            for k in (
                "single_instance",
                "centroid",
                "centered_instance",
                "bottomup",
                "multi_class_bottomup",
                "multi_class_topdown",
                "bottomup_segmentation",
                "centered_instance_segmentation",
                "semantic_segmentation",
            )
            if getattr(self, k) is not None
        ]
        if len(set_ones) != 1:
            raise ValueError(f"Exactly one head config must be set; found: {set_ones or 'none'}.")
        return set_ones[0]


@dataclass
class ModelConfig:
    """Top-level model config (reference: model_config.py:1370ish)."""

    init_weights: str = "default"
    # Legacy torchvision-weights name (reference model_config.py:112,
    # ConvNeXt/SwinT only). Torchvision snapshots are not available in this
    # build — use backbone_config.pretrained (HF snapshot) or
    # pretrained_backbone_weights (trained ckpt) instead; setting this
    # raises a clear error rather than silently ignoring it.
    pre_trained_weights: Optional[str] = None
    pretrained_backbone_weights: Optional[str] = None
    pretrained_head_weights: Optional[str] = None
    backbone_config: BackboneConfig = field(default_factory=BackboneConfig)
    head_configs: HeadConfig = field(default_factory=HeadConfig)
    total_params: Optional[int] = None
