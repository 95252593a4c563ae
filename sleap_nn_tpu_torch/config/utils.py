"""Config utilities (port of ``sleap_nn_tpu/config/utils.py``)."""

from __future__ import annotations

from pathlib import Path

from sleap_nn_tpu_torch.config.training_job_config import TrainingJobConfig


def get_model_type_from_cfg(cfg: TrainingJobConfig) -> str:
    """The model type: which head leaf is set."""
    return cfg.model_config.head_configs.which()


def get_backbone_type_from_cfg(cfg: TrainingJobConfig) -> str:
    """The backbone type: which backbone leaf is set."""
    return cfg.model_config.backbone_config.which()


def get_backbone_config(cfg: TrainingJobConfig):
    bc = cfg.model_config.backbone_config
    return getattr(bc, bc.which())


def get_head_config(cfg: TrainingJobConfig):
    hc = cfg.model_config.head_configs
    return getattr(hc, hc.which())


def check_output_strides(cfg: TrainingJobConfig) -> TrainingJobConfig:
    """Lower the backbone's output stride to the finest head stride; every
    head stride must be a power of two and a multiple of it."""
    backbone_cfg = get_backbone_config(cfg)
    head_cfg = get_head_config(cfg)
    strides = []
    for leaf_name in ("confmaps", "pafs", "class_maps", "segmentation", "center", "offsets"):
        leaf = getattr(head_cfg, leaf_name, None)
        if leaf is not None and getattr(leaf, "output_stride", None) is not None:
            strides.append(leaf.output_stride)
    if strides:
        min_stride = min(strides)
        if backbone_cfg.output_stride > min_stride:
            backbone_cfg.output_stride = min_stride
        for s in strides:
            if s % backbone_cfg.output_stride != 0 or (s & (s - 1)) != 0:
                raise ValueError(f"Head output strides must be powers of two; got {s}.")
    return cfg


def resolve_model_dir(path) -> Path:
    """The model directory of ``path``: the directory itself, or the one
    holding a file of it (a ``*.ckpt`` file or a JAX orbax directory, a
    ``training_config.yaml``, ...). A SLEAP v1 directory
    (``training_config.json`` + ``best_model.h5``) resolves too, so that
    its loader can refuse it by name."""
    p = Path(path)
    if p.is_file() or (p.is_dir() and p.suffix.lower() == ".ckpt"):
        p = p.parent
    if (p / "training_config.yaml").exists():
        return p
    if (p / "training_config.json").exists() and (p / "best_model.h5").exists():
        return p
    raise FileNotFoundError(f"No training_config.yaml under {path}")
