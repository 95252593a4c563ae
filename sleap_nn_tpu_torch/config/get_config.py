"""Keyword arguments -> structured config: the Python API's ``train(...)``
without a YAML.

Port of ``sleap_nn_tpu/config/get_config.py``: string and dict shorthands
expand into the port's copies of the config dataclasses, so the same
keyword arguments give the same YAML in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

from sleap_nn_tpu_torch.config.base import from_dict
from sleap_nn_tpu_torch.config.data_config import (
    AugmentationConfig,
    DataConfig,
    GeometricConfig,
    IntensityConfig,
    PreprocessingConfig,
)
from sleap_nn_tpu_torch.config.model_config import (
    BackboneConfig,
    BottomUpConfig,
    BottomUpMultiClassConfig,
    BottomUpSegmentationConfig,
    CenteredInstanceConfig,
    CenteredInstanceSegmentationConfig,
    CentroidConfig,
    ConvNextConfig,
    HeadConfig,
    ModelConfig,
    PretrainedConfig,
    SemanticSegmentationConfig,
    SingleInstanceConfig,
    SwinTConfig,
    TopDownCenteredInstanceMultiClassConfig,
    UNetConfig,
    UNetLargeRFConfig,
    UNetMediumRFConfig,
)
from sleap_nn_tpu_torch.config.trainer_config import TrainerConfig
from sleap_nn_tpu_torch.config.training_job_config import TrainingJobConfig

_BACKBONE_PRESETS = {
    "unet": UNetConfig,
    "unet_medium_rf": UNetMediumRFConfig,
    "unet_large_rf": UNetLargeRFConfig,
    "convnext": ConvNextConfig,
    "convnext_tiny": lambda **kw: ConvNextConfig(model_type="tiny", **kw),
    "convnext_small": lambda **kw: ConvNextConfig(model_type="small", **kw),
    "convnext_base": lambda **kw: ConvNextConfig(model_type="base", **kw),
    "convnext_large": lambda **kw: ConvNextConfig(model_type="large", **kw),
    "swint": SwinTConfig,
    "swint_tiny": lambda **kw: SwinTConfig(model_type="tiny", **kw),
    "swint_small": lambda **kw: SwinTConfig(model_type="small", **kw),
    "swint_base": lambda **kw: SwinTConfig(model_type="base", **kw),
    "pretrained": PretrainedConfig,
}

_LEAF_BACKBONES = {"unet": UNetConfig, "convnext": ConvNextConfig, "swint": SwinTConfig,
                   "pretrained": PretrainedConfig}

_HEAD_WRAPPERS = {
    "single_instance": SingleInstanceConfig,
    "centroid": CentroidConfig,
    "centered_instance": CenteredInstanceConfig,
    "bottomup": BottomUpConfig,
    "multi_class_bottomup": BottomUpMultiClassConfig,
    "multi_class_topdown": TopDownCenteredInstanceMultiClassConfig,
    "bottomup_segmentation": BottomUpSegmentationConfig,
    "centered_instance_segmentation": CenteredInstanceSegmentationConfig,
    "semantic_segmentation": SemanticSegmentationConfig,
}

# get_config's keyword arguments that go to the data and model functions;
# the backbone leaves' fields (but in_channels, which the data sets) go to
# the backbone, and everything else to the trainer config.
_DATA_KEYS = {
    "train_labels_path", "val_labels_path", "validation_fraction", "scale",
    "ensure_rgb", "ensure_grayscale", "max_height", "max_width", "crop_size",
    "intensity_aug", "geometric_aug", "use_same_data_for_val",
}
_MODEL_KEYS = {"backbone", "head_configs", "init_weights"}
_BACKBONE_FIELDS = {f.name for c in (UNetConfig, ConvNextConfig, SwinTConfig)
                    for f in dataclasses.fields(c)} - {"in_channels"}

# The names a geometric shorthand sets, and to what.
_GEOMETRIC_SHORTHANDS = {
    "rotation": {"affine_p": 1.0},
    "scale": {"affine_p": 1.0},
    "translate": {"translate_width": 0.02, "translate_height": 0.02, "affine_p": 1.0},
    "erase_scale": {"erase_p": 1.0},
    "mixup": {"mixup_p": 1.0},
    "flip": {"flip_p": 0.5},
}


def get_aug_config(
    intensity_aug: Union[str, List[str], Dict, None] = None,
    geometric_aug: Union[str, List[str], Dict, None] = None,
) -> Optional[AugmentationConfig]:
    """The augmentation config of two shorthands, or None when both are
    None. Intensity names (``uniform_noise``, ``gaussian_noise``,
    ``contrast``, ``brightness``) set ``<name>_p`` to 1; geometric names
    (``rotation``, ``scale``, ``translate``, ``erase_scale``, ``mixup``,
    ``flip``) turn on their transform; a dict is the leaf config itself."""
    if intensity_aug is None and geometric_aug is None:
        return None
    intensity = geometric = None
    if intensity_aug is not None:
        if isinstance(intensity_aug, dict):
            intensity = from_dict(IntensityConfig, intensity_aug)
        else:
            intensity = IntensityConfig()
            for name in [intensity_aug] if isinstance(intensity_aug, str) else intensity_aug:
                setattr(intensity, f"{name}_p", 1.0)
    if geometric_aug is not None:
        if isinstance(geometric_aug, dict):
            geometric = from_dict(GeometricConfig, geometric_aug)
        else:
            geometric = GeometricConfig()
            for name in [geometric_aug] if isinstance(geometric_aug, str) else geometric_aug:
                for key, value in _GEOMETRIC_SHORTHANDS.get(name, {}).items():
                    setattr(geometric, key, value)
    return AugmentationConfig(intensity=intensity, geometric=geometric)


def get_backbone_config(backbone: Union[str, Dict] = "unet", **overrides) -> BackboneConfig:
    """The one-of backbone config of a preset name (``unet_medium_rf``,
    ``convnext_tiny``, ...; ``overrides`` set its fields) or of a dict
    ``{"unet" | "convnext" | "swint" | "pretrained": {...}}``."""
    out = BackboneConfig()
    if isinstance(backbone, dict):
        name = next(iter(backbone))
        if name not in _LEAF_BACKBONES:
            raise ValueError(f"Unknown backbone: {name}; one of {sorted(_LEAF_BACKBONES)}")
        setattr(out, name, from_dict(_LEAF_BACKBONES[name], backbone[name]))
        return out
    if backbone not in _BACKBONE_PRESETS:
        raise ValueError(
            f"Unknown backbone preset: {backbone}; one of {sorted(_BACKBONE_PRESETS)}")
    slot = "unet" if backbone.startswith("unet") else backbone.split("_")[0]
    setattr(out, slot, _BACKBONE_PRESETS[backbone](**overrides))
    return out


def get_head_configs(head_configs: Union[str, Dict]) -> HeadConfig:
    """The one-of head config of a model type's name (every leaf at its
    defaults; the trainer fills part names and edges from the labels) or of
    a dict ``{model_type: {...}}``."""
    out = HeadConfig()
    if isinstance(head_configs, str):
        if head_configs not in _HEAD_WRAPPERS:
            raise ValueError(
                f"Unknown model type: {head_configs}; one of {sorted(_HEAD_WRAPPERS)}")
        wrapper_cls = _HEAD_WRAPPERS[head_configs]
        setattr(out, head_configs,
                from_dict(wrapper_cls, {f.name: {} for f in dataclasses.fields(wrapper_cls)}))
        return out
    name = next(iter(head_configs))
    setattr(out, name, from_dict(_HEAD_WRAPPERS[name], head_configs[name]))
    return out


def get_data_config(
    train_labels_path: Optional[List[str]] = None,
    val_labels_path: Optional[List[str]] = None,
    validation_fraction: float = 0.1,
    scale: float = 1.0,
    ensure_rgb: bool = False,
    ensure_grayscale: bool = False,
    max_height: Optional[int] = None,
    max_width: Optional[int] = None,
    crop_size: Optional[int] = None,
    intensity_aug=None,
    geometric_aug=None,
    **kwargs,
) -> DataConfig:
    """A ``DataConfig`` of flat keyword arguments; other keywords are set on
    it as they are."""
    cfg = DataConfig(
        train_labels_path=list(train_labels_path) if train_labels_path else None,
        val_labels_path=list(val_labels_path) if val_labels_path else None,
        validation_fraction=validation_fraction,
        preprocessing=PreprocessingConfig(
            scale=scale, ensure_rgb=ensure_rgb, ensure_grayscale=ensure_grayscale,
            max_height=max_height, max_width=max_width, crop_size=crop_size),
    )
    aug = get_aug_config(intensity_aug, geometric_aug)
    if aug is not None:
        cfg.augmentation_config = aug
        cfg.use_augmentations_train = True
    for k, v in kwargs.items():
        setattr(cfg, k, v)
    return cfg


def get_model_config(
    backbone: Union[str, Dict] = "unet",
    head_configs: Union[str, Dict] = "single_instance",
    init_weights: str = "default",
    **backbone_overrides,
) -> ModelConfig:
    """A ``ModelConfig`` of a backbone and a head shorthand."""
    return ModelConfig(
        init_weights=init_weights,
        backbone_config=get_backbone_config(backbone, **backbone_overrides),
        head_configs=get_head_configs(head_configs),
    )


def get_trainer_config(
    batch_size: int = 4,
    max_epochs: int = 100,
    learning_rate: float = 1e-4,
    optimizer: str = "Adam",
    save_ckpt: bool = False,
    ckpt_dir: Optional[str] = ".",
    run_name: Optional[str] = None,
    seed: Optional[int] = 42,
    **kwargs,
) -> TrainerConfig:
    """A ``TrainerConfig`` of flat keyword arguments (``batch_size`` for
    both loaders); other keywords are set on it as they are."""
    cfg = TrainerConfig(max_epochs=max_epochs, save_ckpt=save_ckpt, ckpt_dir=ckpt_dir,
                        run_name=run_name, seed=seed, optimizer_name=optimizer)
    cfg.train_data_loader.batch_size = batch_size
    cfg.val_data_loader.batch_size = batch_size
    cfg.optimizer.lr = learning_rate
    for k, v in kwargs.items():
        setattr(cfg, k, v)
    return cfg


def get_config(**kwargs) -> TrainingJobConfig:
    """A whole ``TrainingJobConfig`` of flat keyword arguments, each routed
    to the data, model (backbone fields included) or trainer function. An
    explicit ``output_stride`` also sets every head leaf's stride."""
    data_kw = {k: v for k, v in kwargs.items() if k in _DATA_KEYS}
    model_kw = {k: v for k, v in kwargs.items() if k in _MODEL_KEYS}
    backbone_kw = {k: v for k, v in kwargs.items() if k in _BACKBONE_FIELDS}
    trainer_kw = {k: v for k, v in kwargs.items()
                  if k not in _DATA_KEYS | _MODEL_KEYS | _BACKBONE_FIELDS}
    cfg = TrainingJobConfig(
        data_config=get_data_config(**data_kw),
        model_config=get_model_config(**model_kw, **backbone_kw),
        trainer_config=get_trainer_config(**trainer_kw),
    )
    if "output_stride" in backbone_kw:
        hc = cfg.model_config.head_configs
        wrapper = getattr(hc, hc.which())
        for f in dataclasses.fields(wrapper):
            leaf = getattr(wrapper, f.name)
            if leaf is not None and hasattr(leaf, "output_stride"):
                leaf.output_stride = backbone_kw["output_stride"]
    return cfg
