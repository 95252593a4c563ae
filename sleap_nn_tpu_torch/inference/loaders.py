"""Model-directory loading: a trained model dir -> (model, weights, config).

Port of ``sleap_nn_tpu/inference/loaders.py``: resolve the directory,
read ``training_config.yaml``, rebuild the model and load its checkpoint.
The checkpoint is the explicit ``.ckpt`` path when one is given, else
``best.ckpt``, else ``last.ckpt``: the port's own ``torch.save`` file
(the model's ``state_dict`` under ``model.``, as the reference's Lightning
checkpoints hold it), loaded with ``strict=True``. A JAX trainer's
checkpoint is an orbax directory; reading it needs orbax, which imports
JAX, so the port refuses it and ``tools/orbax_to_torch.py`` converts such
a model dir into one the port loads. SLEAP v1 directories are not ported
(ROADMAP.md section 1, item 9).
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

    @property
    def head_config(self):
        return get_head_config(self.config)

    @property
    def backbone_config(self):
        return get_backbone_config(self.config)


def unported_model_type(model_type: str, backbone_type: str = "unet") -> Optional[str]:
    """Why a model of this type cannot be built by the port yet, or None."""
    if backbone_type != "unet":
        return f"backbone {backbone_type!r} is not ported (ROADMAP.md section 1, item 11)"
    if model_type not in MODEL_TYPES:
        return f"model type {model_type!r} is not ported (ROADMAP.md section 1, item 10)"
    return None


def load_checkpoint_state(ckpt: Path) -> Dict[str, torch.Tensor]:
    """The model ``state_dict`` held by a torch checkpoint (keys under
    ``model.``). A JAX trainer's orbax directory raises, naming the tool
    that converts it."""
    if ckpt.is_dir():
        raise ValueError(
            f"{ckpt} is a JAX trainer's orbax checkpoint; the port reads torch checkpoints "
            "only. Convert the model dir with: python3 tools/orbax_to_torch.py "
            f"{ckpt.parent} OUT_DIR")
    from sleap_nn_tpu_torch.training.model_trainer import ModelTrainer

    return ModelTrainer.load_checkpoint_params(ckpt)


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
    why = unported_model_type(model_type, get_backbone_type_from_cfg(config))
    if why:
        raise NotImplementedError(f"{model_dir}: {why}")
    return model_type, Model.from_config(
        "unet", get_backbone_config(config), get_head_config(config), model_type,
        input_hw=model_input_hw(config))


def load_model(path, params_override: Optional[Dict[str, torch.Tensor]] = None) -> LoadedModel:
    """Load one model dir (``training_config.yaml`` + its checkpoint).

    ``path`` is the dir, a file in it, or a ``.ckpt`` to load in place of
    ``best.ckpt``. The weights load into the model with ``strict=True``.
    """
    p = Path(path)
    explicit_ckpt = p if p.suffix.lower() == ".ckpt" and p.exists() else None
    model_dir = resolve_model_dir(path)
    if not (model_dir / "training_config.yaml").exists():
        raise NotImplementedError(
            f"{model_dir} is a SLEAP v1 model directory; importing it is not ported "
            "(ROADMAP.md section 1, item 9)")
    config = TrainingJobConfig.load_yaml(model_dir / "training_config.yaml")
    model_type, model = build_model(config, model_dir)
    if params_override is not None:
        params = dict(params_override)
    else:
        ckpt = explicit_ckpt or model_dir / "best.ckpt"
        if not ckpt.exists():
            ckpt = model_dir / "last.ckpt"
        params = load_checkpoint_state(ckpt)
    model.load_state_dict(params, strict=True)
    model.eval()

    nodes: List[str] = []
    edges: List[Tuple[str, str]] = []
    skel_list = config.data_config.skeletons or []
    if skel_list:
        skel = skel_list[0]
        nodes = [n["name"] for n in skel.get("nodes", [])]
        edges = [(e["source"]["name"], e["destination"]["name"]) for e in skel.get("edges", [])]
    return LoadedModel(model_dir=model_dir, config=config, model_type=model_type, model=model,
                       params=params, skeleton_nodes=nodes, skeleton_edges=edges)
