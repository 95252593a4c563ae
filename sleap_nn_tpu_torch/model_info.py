"""Model directory inspection.

Port of ``sleap_nn_tpu/model_info.py`` over the port's model dirs.
``sleap-nn-tpu-torch info <path>`` prints the same six sections as the JAX
command: Model Info (run name, type, backbone and head summaries,
parameter count, skeleton), Data (train / val paths, preprocessing,
augmentation), Training (optimizer, scheduler, early stopping), Training
Results (from ``training_log.csv``), Evaluation Metrics (from
``metrics.<split>.<idx>.npz``, any of the three historical names) and
Files (the dir listing with sizes). The JAX command draws them as rich
tables; the port prints them as plain text (rich is not on its import
list), with the same rows. A bare training-config YAML gives the config
sections only. The parameter count is the config's ``total_params``, or,
where the config lacks it, the element count of ``best.ckpt``'s state
dict. A SLEAP v1 dir reports its ``training_config.json`` through the v1
mapper and counts the weights of its ``best_model.h5`` (the JAX command
reads ``training_config.yaml`` only).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

from sleap_nn_tpu_torch.config import (
    TrainingJobConfig,
    get_backbone_config,
    get_backbone_type_from_cfg,
    get_head_config,
    get_model_type_from_cfg,
    resolve_model_dir,
)

Rows = List[Tuple[str, str]]


# -- formatting helpers --------------------------------------------------------


def _format_param_count(count) -> str:
    if count is None:
        return "N/A"
    count = float(count)
    if count >= 1e6:
        return f"{count / 1e6:.2f}M"
    if count >= 1e3:
        return f"{count / 1e3:.1f}K"
    return str(int(count))


def _format_model_type(model_type: Optional[str]) -> str:
    if model_type is None:
        return "Unknown"
    return model_type.replace("_", " ").title()


def _format_file_size(size_bytes: int) -> str:
    size = float(size_bytes)
    for unit in ("B", "KB", "MB", "GB"):
        if size < 1024 or unit == "GB":
            return f"{size:.1f} {unit}" if unit != "B" else f"{int(size)} B"
        size /= 1024
    return f"{size:.1f} GB"


def _shorten_path(path: str, max_len: int = 50) -> str:
    if len(path) <= max_len:
        return path
    return "..." + path[-(max_len - 3):]


def _format_backbone_summary(cfg, backbone_type: Optional[str]) -> str:
    """One-line backbone summary."""
    if backbone_type is None:
        return "Unknown"
    bb = get_backbone_config(cfg)
    if bb is None:
        return backbone_type
    if backbone_type == "unet":
        parts = [f"{bb.filters} filters"]
        if getattr(bb, "filters_rate", None) is not None:
            parts.append(f"{bb.filters_rate}x rate")
        parts.append(f"stride {bb.max_stride}")
        return f"UNet ({', '.join(parts)})"
    if backbone_type == "convnext":
        return f"ConvNeXt ({getattr(bb, 'model_type', 'custom')}, stride {bb.max_stride})"
    if backbone_type == "swint":
        return f"SwinT ({getattr(bb, 'model_type', 'custom')}, stride {bb.max_stride})"
    if backbone_type == "pretrained":
        return f"Pretrained ({getattr(bb, 'model_name', '?')})"
    return backbone_type


def _format_head_summary(cfg, model_type: Optional[str]) -> str:
    """One-line head summary."""
    if model_type is None:
        return "Unknown"
    try:
        head_cfg = get_head_config(cfg)
    except Exception:
        return _format_model_type(model_type)
    parts = []
    confmaps = getattr(head_cfg, "confmaps", None)
    if confmaps is not None:
        parts.append(f"sigma={confmaps.sigma}")
        parts.append(f"output_stride={confmaps.output_stride}")
        part_names = getattr(confmaps, "part_names", None)
        if part_names:
            parts.append(f"{len(part_names)} parts")
    pafs = getattr(head_cfg, "pafs", None)
    if pafs is not None:
        parts.append(f"PAFs (sigma={pafs.sigma}, stride={pafs.output_stride})")
    seg = getattr(head_cfg, "segmentation", None)
    if seg is not None:
        parts.append(f"Segmentation (stride={seg.output_stride})")
    if parts:
        return f"ConfMaps ({', '.join(parts)})" if confmaps is not None else ", ".join(parts)
    return _format_model_type(model_type)


def _dir_config(model_dir: Path) -> TrainingJobConfig:
    """A model dir's training config: ``training_config.yaml``, or a SLEAP
    v1 dir's ``training_config.json`` through the v1 mapper."""
    path = model_dir / "training_config.yaml"
    if not path.exists() and (model_dir / "training_config.json").exists():
        path = model_dir / "training_config.json"
    return TrainingJobConfig.load_yaml(path)


def _param_count(cfg, model_dir: Optional[Path]):
    """The config's ``total_params``, else the element count of
    ``best.ckpt``'s state dict (of a SLEAP v1 dir's ``best_model.h5``)."""
    if cfg.model_config.total_params is not None or model_dir is None:
        return cfg.model_config.total_params
    ckpt = model_dir / "best.ckpt"
    if not ckpt.exists() and (model_dir / "best_model.h5").exists():
        from sleap_nn_tpu_torch.legacy_models import load_keras_weights

        layers = load_keras_weights(model_dir / "best_model.h5").values()
        return int(sum(v.size for w in layers for v in w.values()))
    if not ckpt.exists():
        return None
    import torch

    state = torch.load(ckpt, map_location="cpu", weights_only=False)
    state = state.get("state_dict", state)
    return int(sum(v.numel() for v in state.values() if hasattr(v, "numel")))


def _load_training_log(model_dir: Path) -> Optional[dict]:
    """Summary stats from ``training_log.csv``."""
    log_path = model_dir / "training_log.csv"
    if not log_path.exists():
        return None
    import csv

    with open(log_path) as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None

    def _safe_float(row, *keys):
        for key in keys:
            v = row.get(key, "")
            if v:
                try:
                    return float(v)
                except ValueError:
                    continue
        return None

    val_losses = []
    for row in rows:
        vl = _safe_float(row, "val_loss", "val/loss")
        ep = row.get("epoch")
        if vl is not None and ep is not None:
            try:
                val_losses.append((int(float(ep)), vl))
            except ValueError:
                continue
    last = rows[-1]
    best = min(val_losses, key=lambda x: x[1]) if val_losses else (None, None)
    try:
        epochs_trained = int(float(last["epoch"])) + 1 if "epoch" in last else len(rows)
    except ValueError:
        epochs_trained = len(rows)
    return {
        "epochs_trained": epochs_trained,
        "final_train_loss": _safe_float(last, "train_loss", "train/loss"),
        "final_val_loss": _safe_float(last, "val_loss", "val/loss"),
        "best_val_loss": best[1],
        "best_val_epoch": best[0],
        "final_lr": _safe_float(last, "learning_rate", "train/lr"),
    }


def _load_available_metrics(model_dir: Path) -> Tuple[Optional[dict], str]:
    """The most recent metrics npz, preferring val, then train, then test;
    within a split every known file name is a candidate and the newest
    wins."""
    from sleap_nn_tpu_torch.evaluation import load_metrics

    for split in ("val", "train", "test"):
        candidates = []
        for idx in range(4):
            for name in (
                f"metrics.{split}.{idx}.npz",
                f"{split}_{idx}_pred_metrics.npz",
                f"metrics.{split}_{idx}.npz",
            ):
                p = model_dir / name
                if p.exists():
                    candidates.append(p)
        if candidates:
            latest = max(candidates, key=lambda p: p.stat().st_mtime)
            return load_metrics(latest), split
    return None, ""


# -- structured summary ----------------------------------------------------------


def get_model_info(path) -> Dict:
    """Summarize a trained model dir: type, backbone, params, training log."""
    model_dir = resolve_model_dir(path)
    cfg = _dir_config(model_dir)
    backbone_type = get_backbone_type_from_cfg(cfg)
    backbone = get_backbone_config(cfg)
    info = {
        "model_dir": str(model_dir),
        "model_type": get_model_type_from_cfg(cfg),
        "backbone": backbone_type,
        "backbone_summary": _format_backbone_summary(cfg, backbone_type),
        "head_summary": _format_head_summary(cfg, get_model_type_from_cfg(cfg)),
        "total_params": _param_count(cfg, model_dir),
        "max_stride": backbone.max_stride,
        "output_stride": backbone.output_stride,
        "filters": getattr(backbone, "filters", None),
        "skeleton_nodes": [],
        "has_checkpoint": (model_dir / "best.ckpt").exists(),
        "epochs_trained": None,
        "best_val_loss": None,
    }
    skels = cfg.data_config.skeletons or []
    if skels:
        info["skeleton_nodes"] = [n["name"] for n in skels[0].get("nodes", [])]
    log = _load_training_log(model_dir)
    if log:
        info["epochs_trained"] = log["epochs_trained"]
        info["best_val_loss"] = log["best_val_loss"]
    return info


# -- the report ------------------------------------------------------------------


def model_info_sections(path) -> List[Tuple[str, Rows]]:
    """The report's sections as ``(title, [(property, value), ...])``.
    Raises ``FileNotFoundError`` for a missing path and ``ValueError`` for
    a dir without ``training_config.yaml`` (or a SLEAP v1 dir's
    ``training_config.json`` and ``best_model.h5``)."""
    p = Path(path)
    if not p.exists():
        raise FileNotFoundError(f"Path not found: {path}")
    if p.is_file() and p.suffix in (".yaml", ".yml"):
        cfg = TrainingJobConfig.load_yaml(p)
        model_dir = None
    else:
        try:
            model_dir = resolve_model_dir(p)
            cfg = _dir_config(model_dir)
        except (FileNotFoundError, ValueError):
            raise ValueError(f"No training_config.yaml found in {path}") from None

    model_type = get_model_type_from_cfg(cfg)
    backbone_type = get_backbone_type_from_cfg(cfg)
    sections: List[Tuple[str, Rows]] = []

    rows: Rows = []
    run_name = getattr(cfg.trainer_config, "run_name", None)
    if run_name:
        rows.append(("Run name", str(run_name)))
    description = getattr(cfg, "description", None)
    if description:
        rows.append(("Description", str(description)))
    rows.append(("Model type", _format_model_type(model_type)))
    rows.append(("Backbone", _format_backbone_summary(cfg, backbone_type)))
    rows.append(("Head", _format_head_summary(cfg, model_type)))
    rows.append(("Total parameters", _format_param_count(_param_count(cfg, model_dir))))
    skels = cfg.data_config.skeletons or []
    if skels:
        nodes = skels[0].get("nodes", [])
        edges = skels[0].get("edges", [])
        names = [n.get("name", str(n)) if isinstance(n, dict) else str(n) for n in nodes]
        rows.append((
            "Skeleton",
            f"{len(nodes)} {'node' if len(nodes) == 1 else 'nodes'}, "
            f"{len(edges)} {'edge' if len(edges) == 1 else 'edges'}",
        ))
        if names:
            rows.append(("Nodes", ", ".join(names)))
    sections.append(("Model Info", rows))

    rows = []
    train_paths = cfg.data_config.train_labels_path or []
    if train_paths:
        for tp in train_paths:
            rows.append(("Training data", _shorten_path(str(tp))))
    else:
        rows.append(("Training data", "N/A"))
    for vp in (cfg.data_config.val_labels_path or []):
        rows.append(("Validation data", _shorten_path(str(vp))))
    pre = cfg.data_config.preprocessing
    parts = [f"scale={pre.scale}"]
    if pre.max_height is not None and pre.max_width is not None:
        parts.append(f"{pre.max_height}x{pre.max_width}")
    parts.append(f"crop={pre.crop_size}" if pre.crop_size is not None else "no crop")
    rows.append(("Preprocessing", ", ".join(parts)))
    aug = getattr(cfg.data_config, "use_augmentations_train", False)
    rows.append(("Augmentations", "Enabled" if aug else "Disabled"))
    sections.append(("Data", rows))

    tr = cfg.trainer_config
    rows = []
    opt_name = getattr(tr, "optimizer_name", "Adam")
    lr = getattr(getattr(tr, "optimizer", None), "lr", None)
    rows.append(("Optimizer", f"{opt_name} (lr={lr})" if lr is not None else str(opt_name)))
    if getattr(tr, "max_epochs", None) is not None:
        rows.append(("Max epochs", str(tr.max_epochs)))
    bs = getattr(getattr(tr, "train_data_loader", None), "batch_size", None)
    if bs is not None:
        rows.append(("Batch size", str(bs)))
    sched = getattr(tr, "lr_scheduler", None)
    step_lr = getattr(sched, "step_lr", None) if sched else None
    reduce_lr = getattr(sched, "reduce_lr_on_plateau", None) if sched else None
    if step_lr is not None:
        rows.append(("LR scheduler", f"StepLR (step={getattr(step_lr, 'step_size', '?')}, "
                                     f"gamma={getattr(step_lr, 'gamma', '?')})"))
    elif reduce_lr is not None:
        rows.append(("LR scheduler",
                     f"ReduceLROnPlateau (factor={getattr(reduce_lr, 'factor', '?')}, "
                     f"patience={getattr(reduce_lr, 'patience', '?')})"))
    else:
        rows.append(("LR scheduler", "None"))
    es = getattr(tr, "early_stopping", None)
    if es is not None and getattr(es, "stop_training_on_plateau", False):
        rows.append(("Early stopping", f"patience={getattr(es, 'patience', '?')}, "
                                       f"min_delta={getattr(es, 'min_delta', '?')}"))
    else:
        rows.append(("Early stopping", "Disabled"))
    sections.append(("Training", rows))

    if model_dir is None:
        return sections

    log_stats = _load_training_log(model_dir)
    if log_stats is not None:
        rows = []
        if log_stats["epochs_trained"] is not None:
            rows.append(("Epochs trained", str(log_stats["epochs_trained"])))
        if log_stats["final_train_loss"] is not None:
            rows.append(("Final train loss", f"{log_stats['final_train_loss']:.6f}"))
        if log_stats["final_val_loss"] is not None:
            rows.append(("Final val loss", f"{log_stats['final_val_loss']:.6f}"))
        if log_stats["best_val_loss"] is not None:
            rows.append(("Best val loss", f"{log_stats['best_val_loss']:.6f} "
                                          f"(epoch {log_stats['best_val_epoch']})"))
        if log_stats["final_lr"] is not None:
            rows.append(("Final LR", f"{log_stats['final_lr']}"))
        sections.append(("Training Results", rows))

    metrics, split = _load_available_metrics(model_dir)
    if metrics is not None:
        def _fmt(key, fmt=".4f"):
            val = metrics.get(key)
            if val is None:
                return "N/A"
            try:
                return f"{float(val):{fmt}}"
            except (TypeError, ValueError):
                return str(val)

        sections.append((f"Evaluation Metrics ({split})", [
            ("mOKS", _fmt("mOKS.mOKS")),
            ("mAP (OKS)", _fmt("voc_metrics.oks_voc.mAP")),
            ("mAR (OKS)", _fmt("voc_metrics.oks_voc.mAR")),
            ("Avg distance (px)", _fmt("distance_metrics.avg", ".2f")),
            ("Median distance (px)", _fmt("distance_metrics.p50", ".2f")),
            ("P95 distance (px)", _fmt("distance_metrics.p95", ".2f")),
            ("mPCK", _fmt("pck_metrics.mPCK")),
            ("Vis. precision", _fmt("visibility_metrics.precision")),
            ("Vis. recall", _fmt("visibility_metrics.recall")),
        ]))

    rows = []
    for f in sorted((f for f in model_dir.iterdir() if not f.name.startswith(".")),
                    key=lambda f: f.name):
        if f.is_dir():
            size = sum(q.stat().st_size for q in f.rglob("*") if q.is_file())
            rows.append((f.name + "/", _format_file_size(size)))
        else:
            rows.append((f.name, _format_file_size(f.stat().st_size)))
    sections.append(("Files", rows))
    return sections


def format_model_info(sections: List[Tuple[str, Rows]]) -> str:
    """The sections as plain-text tables: a title line, then one row per
    property with the labels padded to one width (the Files section has a
    ``File`` / ``Size`` header, sizes right-aligned)."""
    out = []
    for title, rows in sections:
        if out:
            out.append("")
        out.append(title)
        if title == "Files":
            rows = [("File", "Size")] + rows
            w0 = max(len(a) for a, _ in rows)
            w1 = max(len(b) for _, b in rows)
            out.extend(f"  {a:<{w0}}  {b:>{w1}}" for a, b in rows)
        else:
            w0 = max((len(a) for a, _ in rows), default=0)
            out.extend(f"  {a:<{w0}}  {b}" for a, b in rows)
    return "\n".join(out)


def print_model_info(path):
    """Print the six sections; a missing path or config exits with 1, as
    the JAX command does."""
    try:
        sections = model_info_sections(path)
    except (FileNotFoundError, ValueError) as e:
        print(f"Error: {e}")
        raise SystemExit(1)
    print(format_model_info(sections))
