"""Data config schema: a copy of ``sleap_nn_tpu/config/data_config.py``
(plain data)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class TilingConfig:
    """Tiled training/inference configuration (reference: data_config.py:90)."""

    enabled: bool = False
    tile_size: Optional[int] = None
    overlap: Optional[int] = None
    min_overlap_fraction: float = 0.25
    blend: str = "gaussian"
    sigma_scale: float = 0.125
    tile_batch_size: Optional[int] = None
    accumulator_device: str = "auto"
    cpu_thresh: float = 0.40
    sampling: str = "foreground"
    tile_fg_fraction: float = 0.5
    samples_per_frame: Optional[int] = None
    center_jitter: float = 0.5
    min_visible_keypoints: int = 1
    steps_per_epoch: Optional[int] = None
    full_frame_pass: bool = False


@dataclass
class PreprocessingConfig:
    """Input preprocessing (reference: data_config.py:149)."""

    ensure_rgb: bool = False
    ensure_grayscale: bool = False
    max_height: Optional[int] = None
    max_width: Optional[int] = None
    scale: float = 1.0
    crop_size: Optional[int] = None
    min_crop_size: int = 100
    crop_padding: Optional[int] = None
    tiling: TilingConfig = field(default_factory=TilingConfig)


@dataclass
class IntensityConfig:
    """Intensity augmentation knobs (reference: data_config.py:196)."""

    uniform_noise_min: float = 0.0
    uniform_noise_max: float = 0.04
    uniform_noise_p: float = 0.0
    gaussian_noise_mean: float = 0.0
    gaussian_noise_std: float = 0.02
    gaussian_noise_p: float = 0.0
    contrast_min: float = 0.9
    contrast_max: float = 1.1
    contrast_p: float = 0.0
    brightness_min: float = 0.9
    brightness_max: float = 1.1
    brightness_p: float = 0.0


@dataclass
class GeometricConfig:
    """Geometric augmentation knobs (reference: data_config.py:229)."""

    rotation_min: float = -15.0
    rotation_max: float = 15.0
    rotation_p: Optional[float] = 1.0
    scale_min: float = 0.9
    scale_max: float = 1.1
    scale_p: Optional[float] = 1.0
    translate_width: float = 0.0
    translate_height: float = 0.0
    translate_p: Optional[float] = None
    affine_p: float = 0.0
    erase_scale_min: float = 0.0001
    erase_scale_max: float = 0.01
    erase_ratio_min: float = 1.0
    erase_ratio_max: float = 1.0
    erase_p: float = 0.0
    mixup_lambda_min: float = 0.01
    mixup_lambda_max: float = 0.05
    mixup_p: float = 0.0
    flip_p: float = 0.0


@dataclass
class AugmentationConfig:
    intensity: Optional[IntensityConfig] = None
    geometric: Optional[GeometricConfig] = None


@dataclass
class DataConfig:
    """Top-level data config (reference: data_config.py:311)."""

    train_labels_path: Optional[List[str]] = None
    val_labels_path: Optional[List[str]] = None
    validation_fraction: float = 0.1
    use_same_data_for_val: bool = False
    test_file_path: Optional[Any] = None
    provider: str = "LabelsReader"
    user_instances_only: bool = True
    data_pipeline_fw: str = "jax_dataset"
    cache_img_path: Optional[str] = None
    use_existing_imgs: bool = False
    delete_cache_imgs_after_training: bool = True
    parallel_caching: bool = True
    cache_workers: int = 0
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    use_augmentations_train: bool = True
    augmentation_config: Optional[AugmentationConfig] = None
    use_negative_frames: bool = False
    negative_loss_weight: float = 1.0
    skeletons: Optional[list] = None
    # Video path remapping applied after loading labels (reference
    # cli.py:341-370 train --video-paths/--video-path-map/--prefix-map).
    video_paths: Optional[List[str]] = None
    video_path_map: Optional[dict] = None
    video_prefix_map: Optional[dict] = None
