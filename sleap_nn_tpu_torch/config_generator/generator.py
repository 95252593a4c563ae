"""Config generation: dataset statistics + recommendation -> TrainingJobConfig.

Port of ``sleap_nn_tpu/config_generator/generator.py``: the same inputs
give the same YAML.
"""

from __future__ import annotations

from typing import Optional

from sleap_nn_tpu_torch.config import TrainingJobConfig, apply_overrides
from sleap_nn_tpu_torch.config.data_config import (
    AugmentationConfig,
    GeometricConfig,
    IntensityConfig,
)
from sleap_nn_tpu_torch.config_generator.analyzer import DatasetStats, analyze_slp
from sleap_nn_tpu_torch.config_generator.recommender import ConfigRecommendation, recommend_config


def generate_config(
    slp_path,
    output_path=None,
    stats: Optional[DatasetStats] = None,
    recommendation: Optional[ConfigRecommendation] = None,
    preset: str = "quality",
    **trainer_overrides,
) -> TrainingJobConfig:
    """Analyze a dataset and emit a ready-to-train config YAML.

    ``preset="throughput"`` applies the recommendation's
    inference-throughput knobs (`recommend_throughput_preset`:
    output_stride=4 heads, <=384 px eval scale, crop 128 for topdown) on
    top of the quality defaults.
    """
    stats = stats or analyze_slp(slp_path)
    rec = recommendation or recommend_config(stats)
    if preset not in ("quality", "throughput"):
        raise ValueError(f"Unknown preset: {preset!r} (quality | throughput)")
    fast = rec.throughput_preset if preset == "throughput" else None
    if preset == "throughput" and fast is None:
        raise ValueError(
            f"No measured throughput preset for backbone {rec.backbone!r}"
        )

    cfg = TrainingJobConfig()
    cfg.data_config.train_labels_path = [str(slp_path)]
    cfg.data_config.preprocessing.scale = rec.scale
    cfg.data_config.preprocessing.max_height = stats.max_height
    cfg.data_config.preprocessing.max_width = stats.max_width
    cfg.data_config.preprocessing.ensure_grayscale = stats.num_channels == 1

    backbone_key = rec.backbone
    apply_overrides(cfg, {
        f"model_config.backbone_config.{backbone_key}.max_stride": rec.max_stride,
        f"model_config.backbone_config.{backbone_key}.output_stride": 2,
        f"model_config.backbone_config.{backbone_key}.in_channels": stats.num_channels,
    })

    pipeline = rec.pipeline.pipeline
    part_names = list(stats.node_names)
    edges = [list(e) for e in stats.edges]
    classes = [f"track_{i}" for i in range(stats.num_tracks)]
    head_overrides = {}
    if pipeline == "single_instance":
        head_overrides = {
            "model_config.head_configs.single_instance.confmaps.part_names": part_names,
            "model_config.head_configs.single_instance.confmaps.sigma": rec.sigma,
            "model_config.head_configs.single_instance.confmaps.output_stride": 2,
        }
    elif pipeline == "bottomup":
        head_overrides = {
            "model_config.head_configs.bottomup.confmaps.part_names": part_names,
            "model_config.head_configs.bottomup.confmaps.sigma": rec.sigma,
            "model_config.head_configs.bottomup.confmaps.output_stride": 2,
            "model_config.head_configs.bottomup.pafs.edges": edges,
            "model_config.head_configs.bottomup.pafs.output_stride": 4,
        }
    elif pipeline == "multi_class_bottomup":
        head_overrides = {
            "model_config.head_configs.multi_class_bottomup.confmaps.part_names": part_names,
            "model_config.head_configs.multi_class_bottomup.confmaps.sigma": rec.sigma,
            "model_config.head_configs.multi_class_bottomup.confmaps.output_stride": 2,
            "model_config.head_configs.multi_class_bottomup.class_maps.classes": classes,
            "model_config.head_configs.multi_class_bottomup.class_maps.output_stride": 2,
        }
    elif pipeline == "centroid":
        # Standalone centroid detector (centroid-only pipeline): one head,
        # full-resolution frames, no crop model.
        head_overrides = {
            "model_config.head_configs.centroid.confmaps.sigma": rec.sigma,
            "model_config.head_configs.centroid.confmaps.output_stride": 2,
        }
    elif pipeline == "multi_class_topdown":
        head_overrides = {
            "model_config.head_configs.multi_class_topdown.confmaps.part_names": part_names,
            "model_config.head_configs.multi_class_topdown.confmaps.sigma": rec.sigma,
            "model_config.head_configs.multi_class_topdown.confmaps.output_stride": 2,
            "model_config.head_configs.multi_class_topdown.class_vectors.classes": classes,
        }
    else:  # topdown -> this config trains the centered-instance stage
        head_overrides = {
            "model_config.head_configs.centered_instance.confmaps.part_names": part_names,
            "model_config.head_configs.centered_instance.confmaps.sigma": rec.sigma,
            "model_config.head_configs.centered_instance.confmaps.output_stride": 2,
        }

    if fast is not None:
        cfg.data_config.preprocessing.scale = min(rec.scale, fast["scale"])
        if "crop_size" in fast:
            cfg.data_config.preprocessing.crop_size = fast["crop_size"]
        apply_overrides(cfg, {
            f"model_config.backbone_config.{backbone_key}.output_stride":
                fast["output_stride"],
        })
        for key in list(head_overrides):
            if key.endswith(".output_stride"):
                head_overrides[key] = max(
                    fast["output_stride"], head_overrides[key]
                )
    apply_overrides(cfg, head_overrides)
    cfg.trainer_config.train_data_loader.batch_size = rec.batch_size
    cfg.data_config.use_augmentations_train = True
    cfg.data_config.augmentation_config = AugmentationConfig(
        intensity=IntensityConfig(),
        geometric=GeometricConfig(
            rotation_min=rec.rotation[0], rotation_max=rec.rotation[1], affine_p=0.5
        ),
    )
    for key, value in trainer_overrides.items():
        setattr(cfg.trainer_config, key, value)
    if output_path is not None:
        cfg.save_yaml(output_path)
    return cfg
