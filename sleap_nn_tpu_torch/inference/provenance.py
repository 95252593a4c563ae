"""Inference provenance attached to saved labels.

Port of ``sleap_nn_tpu/inference/provenance.py``:
``build_inference_provenance`` (model paths and config hashes,
timestamps, input lineage, frame selection, inference and tracking
parameters, device, CLI arguments, system info),
``build_tracking_only_provenance`` and ``merge_provenance``. The system
fields report torch, CUDA and the CUDA device in place of the JAX
package's jax version and XLA backend; the version key is
``sleap_nn_tpu_torch_version``.
"""

from __future__ import annotations

import hashlib
import platform
import sys
import time
from datetime import datetime
from pathlib import Path
from typing import Any, Dict, List, Optional, Union

import torch

from sleap_nn_tpu_torch import __version__


def _file_sha256(path: Path, limit: int = 1 << 24) -> Optional[str]:
    try:
        h = hashlib.sha256()
        with open(path, "rb") as f:
            h.update(f.read(limit))
        return h.hexdigest()
    except Exception:
        return None


def _posix(p) -> str:
    return Path(p).resolve().as_posix() if isinstance(p, (str, Path)) else str(p)


def _system_info_fields() -> Dict:
    """Compact CUDA system summary for provenance (never raises)."""
    info: Dict[str, Any] = {
        "python_version": sys.version.split()[0],
        "platform": platform.platform(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
    }
    try:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        info["accelerator"] = torch.cuda.get_device_name(0) if n else None
        info["device_count"] = n or None
    except Exception:
        info["accelerator"] = None
    return info


def build_inference_provenance(
    model_dirs: Optional[List] = None,
    stats: Optional[Dict] = None,
    extra: Optional[Dict] = None,
    *,
    model_type: Optional[str] = None,
    start_time: Optional[datetime] = None,
    end_time: Optional[datetime] = None,
    input_labels=None,
    input_path: Optional[Union[str, Path]] = None,
    frames_processed: Optional[int] = None,
    frames_total: Optional[int] = None,
    frame_selection_method: Optional[str] = None,
    inference_params: Optional[Dict[str, Any]] = None,
    tracking_params: Optional[Dict[str, Any]] = None,
    device: Optional[str] = None,
    cli_args: Optional[Dict[str, Any]] = None,
    include_system_info: bool = True,
    backend: Optional[str] = None,
) -> Dict:
    """The provenance dict stored on predicted Labels.

    ``model_dirs`` / ``stats`` / ``extra`` are the predictor's call (its
    per-run stats land under ``"stats"``); ``run.predict`` adds the run's
    lineage through the keywords. ``backend`` is the type of the device
    the run used (``"cuda"`` or ``"cpu"``), None when not told.
    """
    prov: Dict[str, Any] = {}

    # Timestamps + runtime.
    if start_time is not None:
        prov["inference_start_timestamp"] = start_time.isoformat()
    if end_time is not None:
        prov["inference_end_timestamp"] = end_time.isoformat()
    if start_time is not None and end_time is not None:
        prov["inference_runtime_seconds"] = (end_time - start_time).total_seconds()

    prov["sleap_nn_tpu_torch_version"] = __version__
    prov["torch_version"] = torch.__version__
    prov["platform"] = platform.platform()
    prov["python"] = sys.version.split()[0]
    prov["backend"] = backend
    prov["timestamp"] = time.strftime("%Y-%m-%dT%H:%M:%S")

    # Model lineage: absolute POSIX paths + training-config hashes.
    if model_dirs is not None:
        models = []
        for d in model_dirs:
            d = Path(d)
            entry: Dict[str, Any] = {"path": str(d)}
            cfg = d / "training_config.yaml"
            if cfg.exists():
                entry["training_config_sha256"] = _file_sha256(cfg)
            models.append(entry)
        prov["models"] = models
        prov["model_paths"] = [_posix(m["path"]) for m in models]
    if model_type is not None:
        prov["model_type"] = model_type

    # Input data lineage.
    if input_path is not None:
        prov["source_file"] = _posix(input_path)
    if input_labels is not None and hasattr(input_labels, "provenance"):
        input_prov = dict(getattr(input_labels, "provenance") or {})
        if input_prov:
            prov["input_provenance"] = input_prov
            if "filename" in input_prov:
                prov["source_labels"] = input_prov["filename"]

    # Frame selection.
    if frames_processed is not None or frames_total is not None:
        frame_info: Dict[str, Any] = {}
        if frame_selection_method is not None:
            frame_info["method"] = frame_selection_method
        if frames_processed is not None:
            frame_info["frames_processed"] = frames_processed
        if frames_total is not None:
            frame_info["frames_total"] = frames_total
        prov["frame_selection"] = frame_info

    # Inference / tracking parameter capture (None values dropped).
    if inference_params is not None:
        clean = {
            k: (v.as_posix() if isinstance(v, Path) else v)
            for k, v in inference_params.items()
            if v is not None
        }
        if clean:
            prov["inference_config"] = clean
    if tracking_params is not None:
        clean = {k: v for k, v in tracking_params.items() if v is not None}
        if clean:
            prov["tracking_config"] = clean

    if device is not None:
        prov["device"] = device
    if cli_args is not None:
        clean = {k: v for k, v in cli_args.items() if v is not None}
        if clean:
            prov["cli_args"] = clean

    if include_system_info:
        try:
            prov["system_info"] = _system_info_fields()
        except Exception:
            pass  # provenance must never fail inference

    if stats:
        prov["stats"] = dict(stats)
    if extra:
        prov.update(extra)
    return prov


def build_tracking_only_provenance(
    input_labels=None,
    input_path: Optional[Union[str, Path]] = None,
    start_time: Optional[datetime] = None,
    end_time: Optional[datetime] = None,
    tracking_params: Optional[Dict[str, Any]] = None,
    frames_processed: Optional[int] = None,
    include_system_info: bool = True,
) -> Dict:
    """Provenance for a tracking-only run (no model inference)."""
    prov: Dict[str, Any] = {}
    if start_time is not None:
        prov["tracking_start_timestamp"] = start_time.isoformat()
    if end_time is not None:
        prov["tracking_end_timestamp"] = end_time.isoformat()
    if start_time is not None and end_time is not None:
        prov["tracking_runtime_seconds"] = (end_time - start_time).total_seconds()
    prov["sleap_nn_tpu_torch_version"] = __version__
    prov["pipeline_type"] = "tracking_only"
    if input_path is not None:
        prov["source_file"] = _posix(input_path)
    if input_labels is not None and hasattr(input_labels, "provenance"):
        input_prov = dict(getattr(input_labels, "provenance") or {})
        if input_prov:
            prov["input_provenance"] = input_prov
            if "filename" in input_prov:
                prov["source_labels"] = input_prov["filename"]
    if frames_processed is not None:
        prov["frames_processed"] = frames_processed
    if tracking_params is not None:
        clean = {k: v for k, v in tracking_params.items() if v is not None}
        if clean:
            prov["tracking_config"] = clean
    if include_system_info:
        try:
            prov["system_info"] = _system_info_fields()
        except Exception:
            pass
    return prov


def merge_provenance(
    base_provenance: Dict[str, Any],
    additional: Dict[str, Any],
    overwrite: bool = True,
) -> Dict[str, Any]:
    """Merge provenance dicts without mutating either input."""
    result = dict(base_provenance)
    for key, value in additional.items():
        if key not in result or overwrite:
            result[key] = value
    return result
