"""Pipeline and hyperparameter recommendation.

Port of ``sleap_nn_tpu/config_generator/recommender.py``. One deliberate
difference: the throughput preset's ``note`` states no frames/s figure
(the JAX package's is a TPU measurement).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from sleap_nn_tpu_torch.config_generator.analyzer import DatasetStats
from sleap_nn_tpu_torch.config_generator.architecture_estimates import (
    recommend_default_max_stride,
)


@dataclasses.dataclass
class PipelineRecommendation:
    # single_instance | centroid | topdown | bottomup | multi_class_topdown |
    # multi_class_bottomup
    pipeline: str
    reason: str
    confidence: float = 1.0


@dataclasses.dataclass
class ConfigRecommendation:
    pipeline: PipelineRecommendation
    backbone: str = "unet"
    backbone_reason: str = ""
    sigma: float = 5.0
    sigma_reason: str = ""
    scale: float = 1.0
    scale_reason: str = ""
    batch_size: int = 4
    batch_size_reason: str = ""
    max_stride: int = 16
    rotation: Tuple[float, float] = (-180.0, 180.0)
    rotation_reason: str = ""
    # The inference-throughput variant of the recommended config; None
    # when the backbone family has no preset.
    throughput_preset: Optional[Dict] = None

    def summary(self) -> Dict:
        out = {
            "pipeline": self.pipeline.pipeline,
            "backbone": self.backbone,
            "sigma": self.sigma,
            "scale": self.scale,
            "batch_size": self.batch_size,
            "max_stride": self.max_stride,
            "rotation": list(self.rotation),
        }
        if self.throughput_preset is not None:
            out["throughput_preset"] = self.throughput_preset
        return out


def recommend_pipeline(stats: DatasetStats) -> PipelineRecommendation:
    """Choose the model family from dataset shape (reference: :89)."""
    if stats.is_single_instance:
        return PipelineRecommendation(
            "single_instance",
            "Only one instance per frame — single-instance confmaps are "
            "simplest and fastest.",
        )
    if stats.num_nodes == 1:
        # A 1-node skeleton carries no pose — detection IS the task. A
        # standalone centroid model localizes every instance without a crop
        # stage (reference centroid-only pipeline,
        # tests/test_config_generator_yaml.py:318).
        return PipelineRecommendation(
            "centroid",
            "Single-node skeleton — a standalone centroid detector "
            "localizes all instances; no pose stage is needed.",
            confidence=0.9,
        )
    if stats.has_tracks and stats.num_tracks <= 10:
        if stats.overlap_frequency > 0.3:
            return PipelineRecommendation(
                "multi_class_bottomup",
                "Tracked identities with frequent overlap — class maps "
                "disambiguate identities without crops.",
                confidence=0.8,
            )
        return PipelineRecommendation(
            "multi_class_topdown",
            "Tracked identities with limited overlap — supervised-ID "
            "top-down gives the best identity accuracy.",
            confidence=0.9,
        )
    if stats.overlap_frequency > 0.3:
        return PipelineRecommendation(
            "bottomup",
            "Frequent instance overlap — bottom-up PAF grouping handles "
            "crowded scenes better than crops.",
            confidence=0.8,
        )
    return PipelineRecommendation(
        "topdown",
        "Multiple well-separated instances — two-stage top-down is the "
        "most accurate default.",
        confidence=0.9,
    )


def _recommend_backbone(stats: DatasetStats) -> Tuple[str, str]:
    if stats.num_labeled_frames >= 5000 and stats.max_height * stats.max_width >= 512 * 512:
        return "convnext", "Large dataset + large images justify a bigger encoder."
    return "unet", "UNet is the best accuracy/speed tradeoff for typical dataset sizes."


def _recommend_sigma(stats: DatasetStats, pipeline: str) -> Tuple[float, str]:
    if pipeline in ("topdown", "multi_class_topdown") and stats.avg_bbox_size:
        pass
    if pipeline == "centroid":
        return 2.5, "Tighter sigma for precise standalone centroid localization"
    if stats.is_multi_instance and stats.overlap_frequency > 0.3:
        return 2.5, "Tighter sigma for multi-instance disambiguation"
    if stats.avg_bbox_size and stats.avg_bbox_size < 50:
        return 2.5, "Small animals need precise localization"
    if stats.avg_bbox_size and stats.avg_bbox_size > 200:
        return 7.5, "Larger sigma for large animals (easier to learn)"
    return 5.0, "Default sigma for medium-sized animals"


def _recommend_scale(stats: DatasetStats) -> Tuple[float, str]:
    px = stats.max_height * stats.max_width
    if px >= 2048 * 2048:
        return 0.25, "Very large images - scaling required for memory"
    if px >= 1024 * 1024:
        return 0.5, "Large images - scaling recommended"
    return 1.0, "Image size suitable for full resolution"


def _recommend_batch_size(stats: DatasetStats, backbone: str) -> Tuple[int, str]:
    px = stats.max_height * stats.max_width
    if backbone in ("swint", "convnext"):
        if px >= 1024 * 1024:
            return 2, "Large images with transformer backbone - reduced batch size"
        return 4, "Standard batch size for transformer backbone"
    if px >= 2048 * 2048:
        return 2, "Very large images - reduced batch size for memory"
    if px >= 1024 * 1024:
        return 4, "Large images - moderate batch size"
    return 8, "Moderate image size allows larger batch"


def _recommend_rotation(view_type: str) -> Tuple[Tuple[float, float], str]:
    if view_type == "top":
        return (-180.0, 180.0), "Top-view: all orientations are valid"
    if view_type == "side":
        return (-15.0, 15.0), "Side-view: limited rotation (upside-down unnatural)"
    return (-30.0, 30.0), "Unknown view: conservative rotation range"


def recommend_throughput_preset(
    stats: DatasetStats, pipeline: str, backbone: str
) -> Optional[Dict]:
    """Inference-throughput knobs for the recommended pipeline.

    The reference's own preset knobs: heads at ``output_stride=4`` and
    frames scaled to at most 384 px (a crop of 128 for the top-down
    families), against the quality defaults (output stride 2, full
    resolution). ``config --auto --preset throughput`` emits them.

    Only UNet backbones have the preset; returns None otherwise.
    """
    if backbone != "unet":
        return None
    max_dim = max(stats.max_height or 0, stats.max_width or 0) or 384
    scale = min(1.0, 384.0 / max_dim)
    preset: Dict = {
        "output_stride": 4,
        "scale": round(scale, 4),
        "note": (
            "Throughput preset (reference output_stride=4 head option, "
            "<=384 px eval scale): fewer pixels through the UNet and "
            "coarser confidence maps for faster inference than the "
            "quality config. Expect coarser localization: confmap cells "
            "are output_stride px apart before refinement."
        ),
    }
    if pipeline in ("topdown", "multi_class_topdown"):
        preset["crop_size"] = 128
    return preset


def recommend_config(stats: DatasetStats) -> ConfigRecommendation:
    """Full recommendation bundle (reference: :297)."""
    pipeline = recommend_pipeline(stats)
    backbone, backbone_reason = _recommend_backbone(stats)
    sigma, sigma_reason = _recommend_sigma(stats, pipeline.pipeline)
    scale, scale_reason = _recommend_scale(stats)
    batch, batch_reason = _recommend_batch_size(stats, backbone)
    rotation, rot_reason = _recommend_rotation(stats.view_type)
    max_stride = recommend_default_max_stride(stats.avg_bbox_diagonal or 64.0, scale)
    return ConfigRecommendation(
        pipeline=pipeline,
        backbone=backbone,
        backbone_reason=backbone_reason,
        sigma=sigma,
        sigma_reason=sigma_reason,
        scale=scale,
        scale_reason=scale_reason,
        batch_size=batch,
        batch_size_reason=batch_reason,
        max_stride=max_stride,
        rotation=rotation,
        rotation_reason=rot_reason,
        throughput_preset=recommend_throughput_preset(
            stats, pipeline.pipeline, backbone
        ),
    )
