"""SLEAP v1 model import: a Keras ``best_model.h5`` + ``training_config.json``
-> the port's ``Model`` and ``state_dict``.

Port of ``sleap_nn_tpu/legacy_models.py``. The Keras weights are read with
the port's own ``io/hdf5.py`` (no h5py): every dataset under
``model_weights`` whose name ends in ``:0``, keyed by its layer (the first
path component) and its kind (``kernel`` / ``bias``). A layer name maps to
the JAX package's flax path (Keras stores conv kernels in HWIO, flax's
layout), and the flax path to the port's ``state_dict`` key through
``weights.flax_path_for``, which also turns the kernel into torch's layout.
A Keras ``Conv2DTranspose`` kernel is ``(h, w, OUT, IN)``: its last two
axes are swapped first. Imported transposed convs keep the "tf"
(flax SAME) phase of the Keras layer.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from sleap_nn_tpu_torch.config import TrainingJobConfig
from sleap_nn_tpu_torch.config.base import apply_overrides
from sleap_nn_tpu_torch.io import hdf5
from sleap_nn_tpu_torch.weights import _to_torch_layout, torch_key_paths


def load_keras_weights(h5_path) -> Dict[str, Dict[str, np.ndarray]]:
    """Every layer's weights of a Keras ``best_model.h5``:
    ``{layer: {"kernel": array, "bias": array}}``."""
    weights: Dict[str, Dict[str, np.ndarray]] = {}
    if not Path(h5_path).exists():
        raise FileNotFoundError(f"Legacy Keras weights file not found: {h5_path}")
    with hdf5.File(h5_path, "r") as f:
        if "model_weights" not in f:
            raise ValueError(
                f"{h5_path} has no 'model_weights' group — not a Keras "
                "checkpoint (SLEAP v1 saves best_model.h5 via keras).")

        def visit(name, obj):
            if isinstance(obj, hdf5.Dataset) and name.endswith(":0"):
                parts = name.split("/")
                kind = parts[-1].split(":")[0]  # kernel | bias
                weights.setdefault(parts[0], {})[kind] = np.asarray(obj[()])

        f["model_weights"].visititems(visit)
    return weights


def legacy_config_mapper(legacy: dict) -> TrainingJobConfig:
    """Map a SLEAP v1 ``training_config.json`` to a ``TrainingJobConfig``,
    as the JAX package's mapper does, field for field."""
    cfg = TrainingJobConfig()
    data = legacy.get("data", {})
    pre = data.get("preprocessing", {})
    cfg.data_config.train_labels_path = [
        p for p in [data.get("labels", {}).get("training_labels")] if p]
    val = data.get("labels", {}).get("validation_labels")
    if val:
        cfg.data_config.val_labels_path = [val]
    cfg.data_config.validation_fraction = data.get("labels", {}).get("validation_fraction", 0.1)
    cfg.data_config.preprocessing.ensure_rgb = bool(pre.get("ensure_rgb", False))
    cfg.data_config.preprocessing.ensure_grayscale = bool(pre.get("ensure_grayscale", False))
    cfg.data_config.preprocessing.scale = float(pre.get("input_scaling", 1.0))
    cfg.data_config.preprocessing.crop_size = data.get("instance_cropping", {}).get("crop_size")

    model = legacy.get("model", {})
    unet = (model.get("backbone") or {}).get("unet")
    if unet:
        apply_overrides(cfg, {
            "model_config.backbone_config.unet.filters": int(unet.get("filters", 32)),
            "model_config.backbone_config.unet.filters_rate": float(unet.get("filters_rate", 1.5)),
            "model_config.backbone_config.unet.max_stride": int(unet.get("max_stride", 16)),
            "model_config.backbone_config.unet.output_stride": int(unet.get("output_stride", 2)),
            "model_config.backbone_config.unet.stem_stride": unet.get("stem_stride"),
            "model_config.backbone_config.unet.middle_block": bool(unet.get("middle_block", True)),
            "model_config.backbone_config.unet.up_interpolate": bool(unet.get("up_interpolate", True)),
            "model_config.backbone_config.unet.stacks": int(unet.get("stacks", 1)),
            "model_config.backbone_config.unet.in_channels": 3,
            # Keras Conv2DTranspose(padding="same") has the TF phase.
            "model_config.backbone_config.unet.trans_conv_phase": "tf",
        })

    heads = model.get("heads", {})
    head = "model_config.head_configs."
    if heads.get("single_instance"):
        h = heads["single_instance"]
        apply_overrides(cfg, {
            head + "single_instance.confmaps.part_names": h.get("part_names"),
            head + "single_instance.confmaps.sigma": h.get("sigma", 5.0),
            head + "single_instance.confmaps.output_stride": h.get("output_stride", 1),
        })
    elif heads.get("centroid"):
        h = heads["centroid"]
        apply_overrides(cfg, {
            head + "centroid.confmaps.anchor_part": h.get("anchor_part"),
            head + "centroid.confmaps.sigma": h.get("sigma", 5.0),
            head + "centroid.confmaps.output_stride": h.get("output_stride", 1),
        })
    elif heads.get("centered_instance"):
        h = heads["centered_instance"]
        apply_overrides(cfg, {
            head + "centered_instance.confmaps.part_names": h.get("part_names"),
            head + "centered_instance.confmaps.anchor_part": h.get("anchor_part"),
            head + "centered_instance.confmaps.sigma": h.get("sigma", 5.0),
            head + "centered_instance.confmaps.output_stride": h.get("output_stride", 1),
        })
    elif heads.get("multi_instance"):
        h = heads["multi_instance"]
        cm, pafs = h.get("confmaps", {}), h.get("pafs", {})
        apply_overrides(cfg, {
            head + "bottomup.confmaps.part_names": cm.get("part_names"),
            head + "bottomup.confmaps.sigma": cm.get("sigma", 5.0),
            head + "bottomup.confmaps.output_stride": cm.get("output_stride", 1),
            head + "bottomup.pafs.edges": pafs.get("edges"),
            head + "bottomup.pafs.sigma": pafs.get("sigma", 15.0),
            head + "bottomup.pafs.output_stride": pafs.get("output_stride", 1),
        })
    elif heads.get("multi_class_bottomup"):
        h = heads["multi_class_bottomup"]
        cm, cmaps = h.get("confmaps", {}), h.get("class_maps", {})
        apply_overrides(cfg, {
            head + "multi_class_bottomup.confmaps.part_names": cm.get("part_names"),
            head + "multi_class_bottomup.confmaps.sigma": cm.get("sigma", 5.0),
            head + "multi_class_bottomup.confmaps.output_stride": cm.get("output_stride", 1),
            head + "multi_class_bottomup.confmaps.loss_weight": cm.get("loss_weight", 1.0),
            head + "multi_class_bottomup.class_maps.classes": cmaps.get("classes"),
            head + "multi_class_bottomup.class_maps.sigma": cmaps.get("sigma", 5.0),
            head + "multi_class_bottomup.class_maps.output_stride": cmaps.get("output_stride", 1),
            head + "multi_class_bottomup.class_maps.loss_weight": cmaps.get("loss_weight", 1.0),
        })
    elif heads.get("multi_class_topdown"):
        h = heads["multi_class_topdown"]
        cm, cvec = h.get("confmaps", {}), h.get("class_vectors", {})
        apply_overrides(cfg, {
            head + "multi_class_topdown.confmaps.part_names": cm.get("part_names"),
            head + "multi_class_topdown.confmaps.anchor_part": cm.get("anchor_part"),
            head + "multi_class_topdown.confmaps.sigma": cm.get("sigma", 5.0),
            head + "multi_class_topdown.confmaps.output_stride": cm.get("output_stride", 1),
            head + "multi_class_topdown.class_vectors.classes": cvec.get("classes"),
            head + "multi_class_topdown.class_vectors.num_fc_layers": cvec.get("num_fc_layers", 1),
            head + "multi_class_topdown.class_vectors.num_fc_units": cvec.get("num_fc_units", 64),
            head + "multi_class_topdown.class_vectors.loss_weight": cvec.get("loss_weight", 1.0),
        })

    opt = legacy.get("optimization", {})
    cfg.trainer_config.train_data_loader.batch_size = int(opt.get("batch_size", 4))
    cfg.trainer_config.max_epochs = int(opt.get("epochs", 100))
    cfg.trainer_config.optimizer_name = str(opt.get("optimizer", "adam")).capitalize()
    cfg.trainer_config.optimizer.lr = float(opt.get("initial_learning_rate", 1e-4))
    lrs = opt.get("learning_rate_schedule", {})
    if lrs.get("reduce_on_plateau"):
        plateau = "trainer_config.lr_scheduler.reduce_lr_on_plateau."
        apply_overrides(cfg, {
            plateau + "factor": lrs.get("reduction_factor", 0.5),
            plateau + "threshold": lrs.get("plateau_min_delta", 1e-6),
            plateau + "patience": lrs.get("plateau_patience", 5),
            plateau + "cooldown": lrs.get("plateau_cooldown", 3),
            plateau + "min_lr": lrs.get("min_learning_rate", 0.0),
        })
    es = opt.get("early_stopping", {})
    cfg.trainer_config.early_stopping.stop_training_on_plateau = bool(
        es.get("stop_training_on_plateau", True))
    cfg.trainer_config.early_stopping.patience = int(es.get("plateau_patience", 10))
    hkm = opt.get("hard_keypoint_mining", {})
    if hkm:
        cfg.trainer_config.online_hard_keypoint_mining.online_mining = bool(
            hkm.get("online_mining", False))

    outputs = legacy.get("outputs", {})
    # run_name = prefix + name + suffix (the documented intent of the v1
    # schema).
    full = "".join(outputs.get(k) or "" for k in ("run_name_prefix", "run_name",
                                                  "run_name_suffix"))
    cfg.trainer_config.run_name = full if full else None
    skels = data.get("labels", {}).get("skeletons") or []
    if skels:
        nodes, edges = _decode_legacy_skeleton(skels[0])
        cfg.data_config.skeletons = [{
            "nodes": [{"name": n} for n in nodes],
            "edges": [{"source": {"name": s}, "destination": {"name": d}} for s, d in edges],
            "symmetries": [],
            "name": skels[0].get("graph", {}).get("name", "Skeleton-0"),
        }]
    return cfg


def _decode_legacy_skeleton(skel_json: dict) -> Tuple[list, list]:
    """Decode a SLEAP v1 jsonpickle skeleton (``py/object`` Node states,
    ``py/id`` back-references)."""
    memo = {}
    order = []

    def node_name(obj):
        if isinstance(obj, dict):
            if "py/object" in obj and "py/state" in obj:
                name = obj["py/state"]["py/tuple"][0]
                memo[len(memo) + 1] = name
                return name
            if "py/id" in obj:
                return memo.get(obj["py/id"])
        return obj

    edges = []
    for link in skel_json.get("links", []):
        s = node_name(link.get("source"))
        d = node_name(link.get("target"))
        for n in (s, d):
            if n is not None and n not in order:
                order.append(n)
        if s is not None and d is not None:
            edges.append((s, d))
    for n in skel_json.get("nodes", []):
        name = node_name(n.get("id"))
        if name is not None and name not in order:
            order.append(name)
    return order, edges


def _legacy_name_to_path(name: str) -> Optional[Tuple[str, ...]]:
    """A Keras layer name -> the JAX package's flax module path."""
    if "_middle_expand_conv" in name or "_middle_contract_conv" in name:
        stack = name.split("_")[0]
        kind = "middle_expand" if "middle_expand" in name else "middle_contract"
        conv = name.rsplit("_", 1)[-1]
        return ("backbone", f"{stack}_{kind}", conv)
    if "_enc" in name and "_conv" in name:
        stack, enc, conv = name.split("_")
        return ("backbone", f"{stack}_enc", enc, conv)
    if "_dec" in name:
        # stack0_dec0_s8_to_s4_refine_conv0 / ..._trans_conv
        parts = name.split("_")
        return ("backbone", f"{parts[0]}_dec", "_".join(parts[1:5]), "_".join(parts[5:]))
    if "stem" in name and "_conv" in name:
        stem, conv = name.split("_")
        return ("backbone", "stem", stem, conv)
    if name.startswith("pre_classification") and name.endswith("_fc"):
        idx = name[len("pre_classification"):-len("_fc")]
        return ("ClassVectorsHead", f"fc{idx}")
    if "ClassVectorsHead" in name:
        return ("ClassVectorsHead", "logits")
    if "Head" in name:
        return (name.rsplit("_", 1)[0], "head_conv")
    return None


def map_legacy_to_torch_state(weights: Dict, state: Dict[str, torch.Tensor], paths: Dict
                              ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Place Keras weights into a ``state_dict`` by name.

    ``paths``: ``weights.torch_key_paths`` of the model. Returns
    (new ``state_dict``, mapped names, skipped names), the lists as the JAX
    package's ``map_legacy_to_flax_params`` gives them.
    """
    by_path = {path: (key, kind) for key, (path, kind) in paths.items()}
    modules = {path[:-1] for path in by_path}
    out = dict(state)
    mapped, skipped = [], []
    for name, w in weights.items():
        path = _legacy_name_to_path(name)
        if path is None or path not in modules:
            skipped.append(name)
            continue
        for kind in ("kernel", "bias"):
            if kind in w and path + (kind,) in by_path:
                key, layout = by_path[path + (kind,)]
                value = np.asarray(w[kind])
                if kind == "kernel" and name.endswith("trans_conv"):
                    value = np.swapaxes(value, -1, -2)  # Keras (h, w, OUT, IN)
                want = _flax_shape(out[key].shape, layout)
                if value.shape != want:
                    skipped.append(f"{name}/{kind} (shape {value.shape} vs {want})")
                    continue
                out[key] = torch.from_numpy(
                    np.array(_to_torch_layout(value, layout), dtype=np.float32))
                mapped.append(f"{name}/{kind}")
    return out, mapped, skipped


def _flax_shape(torch_shape, layout: str) -> Tuple[int, ...]:
    """The flax leaf shape of a torch tensor of ``torch_shape``."""
    s = tuple(torch_shape)
    if layout == "conv_kernel":
        return (s[2], s[3], s[1], s[0])
    if layout == "trans_conv_kernel":
        return (s[2], s[3], s[0], s[1])
    if layout == "dense_kernel":
        return (s[1], s[0])
    return s


def load_legacy_model(model_dir):
    """A SLEAP v1 model dir -> (Model, ``state_dict``, TrainingJobConfig,
    ``{"mapped": [...], "skipped": [...]}``).

    The input channels come from the first conv's kernel (the json's
    ensure_rgb / ensure_grayscale flags do not record them). A weight that
    no Keras layer supplies keeps the model's random init, as in the JAX
    package.
    """
    from sleap_nn_tpu_torch.config import (
        get_backbone_config,
        get_head_config,
        get_model_type_from_cfg,
    )
    from sleap_nn_tpu_torch.models.model import Model

    model_dir = Path(model_dir)
    cfg_path = model_dir / "training_config.json"
    if not cfg_path.exists():
        raise FileNotFoundError(f"Not a SLEAP v1 model dir (no training_config.json): {model_dir}")
    cfg = legacy_config_mapper(json.loads(cfg_path.read_text()))
    weights = load_keras_weights(model_dir / "best_model.h5")
    for first in ("stem0_conv0", "stack0_enc0_conv0"):
        if first in weights:
            cfg.model_config.backbone_config.unet.in_channels = int(
                weights[first]["kernel"].shape[2])
            break
    model_type = get_model_type_from_cfg(cfg)
    model = Model.from_config("unet", get_backbone_config(cfg), get_head_config(cfg), model_type)
    state, mapped, skipped = map_legacy_to_torch_state(
        weights, model.state_dict(), torch_key_paths(model))
    model.load_state_dict(state, strict=True)
    model.eval()
    return model, state, cfg, {"mapped": mapped, "skipped": skipped}
