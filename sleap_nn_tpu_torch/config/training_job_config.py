"""Top-level training job config.

Port of ``sleap_nn_tpu/config/training_job_config.py``: the
``{data_config, model_config, trainer_config}`` container and its
fail-fast validation. A SLEAP v1 ``training_config.json`` (the legacy
schema) goes through ``legacy_models.legacy_config_mapper``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from sleap_nn_tpu_torch.config.base import apply_overrides, from_dict, save_yaml, to_dict
from sleap_nn_tpu_torch.config.data_config import DataConfig
from sleap_nn_tpu_torch.config.model_config import ModelConfig
from sleap_nn_tpu_torch.config.trainer_config import TrainerConfig


@dataclass
class TrainingJobConfig:
    """The {data_config, model_config, trainer_config} YAML container."""

    data_config: DataConfig = field(default_factory=DataConfig)
    model_config: ModelConfig = field(default_factory=ModelConfig)
    trainer_config: TrainerConfig = field(default_factory=TrainerConfig)
    name: Optional[str] = ""
    description: Optional[str] = ""
    sleap_nn_version: Optional[str] = None
    filename: Optional[str] = ""

    @classmethod
    def from_dict(cls, data: dict) -> "TrainingJobConfig":
        return from_dict(cls, data)

    @classmethod
    def load_yaml(cls, path, overrides: Optional[Dict] = None) -> "TrainingJobConfig":
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f)
        if isinstance(data, dict) and "model_config" not in data and (
            "model" in data or "optimization" in data
        ):
            # SLEAP v1 schema (top-level model / optimization / outputs).
            from sleap_nn_tpu_torch.legacy_models import legacy_config_mapper

            cfg = legacy_config_mapper(data)
        else:
            cfg = from_dict(cls, data)
        cfg.filename = str(path)
        if overrides:
            apply_overrides(cfg, overrides)
        return cfg

    def to_dict(self) -> dict:
        return to_dict(self)

    def save_yaml(self, path):
        save_yaml(self, path)


def _verify_data_ranges(dc) -> None:
    """Range checks of the data config (the JAX package's, one for one)."""

    def _prop(obj, name, where):
        v = getattr(obj, name, None)
        if v is not None and not (0.0 <= float(v) <= 1.0):
            raise ValueError(f"{where}.{name} must be in [0, 1], got {v}.")

    def _nonneg(obj, name, where):
        v = getattr(obj, name, None)
        if v is not None and float(v) < 0:
            raise ValueError(f"{where}.{name} must be >= 0, got {v}.")

    pre = dc.preprocessing
    if pre.scale is not None and pre.scale <= 0:
        raise ValueError(
            f"data_config.preprocessing.scale must be > 0, got {pre.scale}."
        )
    t = pre.tiling
    for name in ("min_overlap_fraction", "cpu_thresh", "center_jitter",
                 "tile_fg_fraction"):
        _prop(t, name, "tiling")
    if not (0.0 < t.sigma_scale <= 1.0):
        raise ValueError(
            f"tiling.sigma_scale must be in (0, 1], got {t.sigma_scale}."
        )
    if t.min_visible_keypoints < 0:
        raise ValueError(
            f"tiling.min_visible_keypoints must be >= 0, got "
            f"{t.min_visible_keypoints}."
        )
    tiling_enums = {
        "blend": ("gaussian", "pyramid", "constant"),
        "accumulator_device": ("auto", "cpu", "cuda", "device"),
        "sampling": ("foreground", "grid"),
    }
    for name, allowed in tiling_enums.items():
        v = getattr(t, name, None)
        if v is not None and v not in allowed:
            raise ValueError(
                f"tiling.{name} must be one of {allowed}, got {v!r}."
            )
    for name in ("tile_size", "tile_batch_size",
                 "samples_per_frame", "steps_per_epoch"):
        v = getattr(t, name, None)
        if v is not None and int(v) <= 0:
            raise ValueError(f"tiling.{name} must be > 0, got {v}.")
    if t.overlap is not None and int(t.overlap) < 0:
        raise ValueError(f"tiling.overlap must be >= 0, got {t.overlap}.")
    aug = dc.augmentation_config
    if aug is not None:
        inten = getattr(aug, "intensity", None)
        if inten is not None:
            for name in ("uniform_noise_p", "gaussian_noise_p", "contrast_p",
                         "brightness_p"):
                _prop(inten, name, "intensity")
            for name in ("uniform_noise_min", "contrast_min", "contrast_max",
                         "brightness_min", "brightness_max"):
                _nonneg(inten, name, "intensity")
        geo = getattr(aug, "geometric", None)
        if geo is not None:
            for name in ("rotation_p", "scale_p", "translate_p", "affine_p",
                         "erase_p", "mixup_p", "flip_p"):
                _prop(geo, name, "geometric")
            for name in ("scale_min", "scale_max", "mixup_lambda_min",
                         "mixup_lambda_max"):
                _nonneg(geo, name, "geometric")


def verify_training_cfg(cfg: TrainingJobConfig) -> TrainingJobConfig:
    """Fail-fast validation: exactly one backbone and one head leaf set,
    positive epochs and negative-loss weight, the data ranges."""
    cfg.model_config.backbone_config.which()
    cfg.model_config.head_configs.which()
    if cfg.trainer_config.max_epochs <= 0:
        raise ValueError("trainer_config.max_epochs must be > 0.")
    if cfg.data_config.negative_loss_weight <= 0:
        raise ValueError("data_config.negative_loss_weight must be > 0.")
    _verify_data_ranges(cfg.data_config)
    if getattr(cfg.model_config, "pre_trained_weights", None):
        raise ValueError(
            "model_config.pre_trained_weights (torchvision weight names) is "
            "not supported: use model_config.pretrained_backbone_weights."
        )
    return cfg
