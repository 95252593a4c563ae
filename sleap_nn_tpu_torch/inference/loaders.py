"""Model-directory loading: a trained model dir -> (model, weights, config).

Port of ``sleap_nn_tpu/inference/loaders.py``: resolve the directory,
read ``training_config.yaml``, rebuild the model and load its checkpoint.
The checkpoint is the explicit ``.ckpt`` path when one is given, else
``best.ckpt``, else ``last.ckpt``: the port's own ``torch.save`` file
(the model's ``state_dict`` under ``model.``, as the reference's Lightning
checkpoints hold it), loaded with ``strict=True``. A JAX trainer's
checkpoint is an orbax directory; reading it needs orbax, which imports
JAX, so the port refuses it and ``tools/orbax_to_torch.py`` converts such
a model dir into one the port loads. Any backbone the JAX package builds
(``unet``, ``convnext``, ``swint``, ``pretrained``) loads. A dir without
``training_config.yaml`` is a SLEAP v1 model dir (``training_config.json``
+ ``best_model.h5``), imported by ``legacy_models.load_legacy_model``, as
the JAX package does.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import torch

from sleap_nn_tpu_torch.config import (
    TrainingJobConfig,
    get_backbone_config,
    get_backbone_type_from_cfg,
    get_head_config,
    get_model_type_from_cfg,
    resolve_model_dir,
)
from sleap_nn_tpu_torch.data.pipeline import CROP_TYPES
from sleap_nn_tpu_torch.models.model import MODEL_TYPES, Model


@dataclasses.dataclass
class LoadedModel:
    """One trained model ready for inference; ``params`` is its ``state_dict``."""

    model_dir: Path
    config: TrainingJobConfig
    model_type: str
    model: Model
    params: Dict[str, torch.Tensor]
    skeleton_nodes: List[str]
    skeleton_edges: List[Tuple[str, str]]
    # Set by Predictor.from_model_paths(host_resize=True): the scale of the
    # config, whose resize then runs on the host (crop sizes live in the
    # scaled space).
    host_scale: Optional[float] = None

    @property
    def head_config(self):
        return get_head_config(self.config)

    @property
    def backbone_config(self):
        return get_backbone_config(self.config)


def unported_model_type(model_type: str) -> Optional[str]:
    """Why a model of this type cannot be built by the port yet, or None."""
    if model_type not in MODEL_TYPES:
        return f"model type {model_type!r} is not a model type (one of {', '.join(MODEL_TYPES)})"
    return None


def orbax_refusal(ckpt: Path) -> ValueError:
    """The error for a JAX trainer's orbax checkpoint (a directory), naming
    the tool that converts its model dir."""
    return ValueError(
        f"{ckpt} is a JAX trainer's orbax checkpoint; the port reads torch checkpoints "
        "only. Convert the model dir with: python3 tools/orbax_to_torch.py "
        f"{ckpt.parent} OUT_DIR")


def model_input_hw(config: TrainingJobConfig) -> Optional[Tuple[int, int]]:
    """The network input's (height, width) for a crop model (the crop size,
    scaled and rounded up to the max stride, as the trainer renders it);
    None for a model of full frames."""
    pre = config.data_config.preprocessing
    if get_model_type_from_cfg(config) not in CROP_TYPES or not pre.crop_size:
        return None
    size = int(round(pre.crop_size * pre.scale))
    size += (-size) % get_backbone_config(config).max_stride
    return size, size


def build_model(config: TrainingJobConfig, model_dir: Path) -> Tuple[str, Model]:
    """``(model_type, model)`` of a training config, with random weights;
    a model the port cannot build raises ``NotImplementedError``."""
    model_type = get_model_type_from_cfg(config)
    why = unported_model_type(model_type)
    if why:
        raise NotImplementedError(f"{model_dir}: {why}")
    return model_type, Model.from_config(
        get_backbone_type_from_cfg(config), get_backbone_config(config),
        get_head_config(config), model_type, input_hw=model_input_hw(config))


def load_model(path, params_override: Optional[Dict[str, torch.Tensor]] = None) -> LoadedModel:
    """Load one model dir (``training_config.yaml`` + its checkpoint).

    ``path`` is the dir, a file in it, or a ``.ckpt`` to load in place of
    ``best.ckpt``. The weights load into the model with ``strict=True``.
    """
    p = Path(path)
    explicit_ckpt = p if p.suffix.lower() == ".ckpt" and p.exists() else None
    model_dir = resolve_model_dir(path)
    if not (model_dir / "training_config.yaml").exists():
        return _load_legacy_dir(model_dir)
    config = TrainingJobConfig.load_yaml(model_dir / "training_config.yaml")
    model_type, model = build_model(config, model_dir)
    if params_override is not None:
        params = dict(params_override)
    else:
        ckpt = explicit_ckpt or model_dir / "best.ckpt"
        if not ckpt.exists():
            ckpt = model_dir / "last.ckpt"
        from sleap_nn_tpu_torch.training.model_trainer import ModelTrainer

        params = ModelTrainer.load_checkpoint_params(ckpt)  # an orbax dir raises
    model.load_state_dict(params, strict=True)
    model.eval()

    nodes, edges = skeleton_of(config)
    return LoadedModel(model_dir=model_dir, config=config, model_type=model_type, model=model,
                       params=params, skeleton_nodes=nodes, skeleton_edges=edges)


def skeleton_of(config: TrainingJobConfig) -> Tuple[List[str], List[Tuple[str, str]]]:
    """(node names, edges) of the config's first skeleton, or empty lists."""
    skel_list = config.data_config.skeletons or []
    if not skel_list:
        return [], []
    skel = skel_list[0]
    nodes = [n["name"] for n in skel.get("nodes", [])]
    edges = [(e["source"]["name"], e["destination"]["name"]) for e in skel.get("edges", [])]
    return nodes, edges


def _load_legacy_dir(model_dir: Path) -> LoadedModel:
    """A SLEAP v1 model dir -> LoadedModel through the Keras weight importer."""
    from sleap_nn_tpu_torch.legacy_models import load_legacy_model

    model, params, config, _stats = load_legacy_model(model_dir)
    nodes, edges = skeleton_of(config)
    return LoadedModel(model_dir=Path(model_dir), config=config,
                       model_type=get_model_type_from_cfg(config), model=model, params=params,
                       skeleton_nodes=nodes, skeleton_edges=edges)
