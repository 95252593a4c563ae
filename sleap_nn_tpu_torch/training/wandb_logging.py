"""Weights & Biases logging callback, with an offline local run.

Port of ``sleap_nn_tpu/training/wandb_logging.py``: a callback that starts
a wandb run from ``trainer_config.wandb`` (entity, project, name, mode,
group, resume id), logs each epoch's metrics with ``epoch`` as the x-axis
of ``train/*`` and ``val/*``, records the run id in
``trainer_config.wandb.current_run_id`` and can upload the epoch's viz
PNGs. Without the ``wandb`` package (``use_wandb: true`` still does
something visible) a local run directory
``<ckpt_dir>/wandb/offline-run-<id>/`` holds the run config
(``config.json``), an append-only ``metrics.jsonl``, the uploaded files
and ``summary.json``, and a warning is printed. ``wandb`` is imported
inside the callback, never at import time.
"""

from __future__ import annotations

import json
import time
import warnings
from pathlib import Path
from typing import Dict, Optional

from sleap_nn_tpu_torch.training.callbacks import Callback


class _LocalRun:
    """Minimal offline wandb-run stand-in: JSONL metrics + config snapshot."""

    def __init__(self, root: Path, run_id: str, config: Dict):
        self.dir = root / f"offline-run-{run_id}"
        self.dir.mkdir(parents=True, exist_ok=True)
        self.id = run_id
        self.url = self.dir.as_uri()
        with open(self.dir / "config.json", "w") as fp:
            json.dump(config, fp, indent=2, default=str)
        self._metrics = open(self.dir / "metrics.jsonl", "a")

    def log(self, logs: Dict):
        self._metrics.write(json.dumps(logs, default=float) + "\n")
        self._metrics.flush()

    def save(self, path):  # parity with wandb.save for viz images
        import shutil

        dest = self.dir / "files"
        dest.mkdir(exist_ok=True)
        shutil.copy2(path, dest / Path(path).name)

    def finish(self, summary: Optional[Dict] = None):
        if summary is not None:
            with open(self.dir / "summary.json", "w") as fp:
                json.dump(summary, fp, indent=2, default=float)
        self._metrics.close()


def peaks_to_boxes(
    peaks,
    vals=None,
    box_size: float = 5.0,
    node_names=None,
    confmap_threshold: float = 0.1,
):
    """Peak points -> a wandb ``boxes`` payload: one ``box_size``-pixel box
    per visible peak.

    Accepts ``(n_nodes, 2)`` or ``(n_instances, n_nodes, 2)``; NaN peaks and
    peaks whose confidence is below ``confmap_threshold`` are skipped.
    Returns the ``{"predictions": {"box_data": [...], "class_labels": ...}}``
    dict wandb.Image expects.
    """
    import numpy as np

    pts = np.asarray(peaks, float)
    if pts.ndim == 2:
        pts = pts[None]
    conf = None if vals is None else np.asarray(vals, float).reshape(pts.shape[:2])
    half = box_size / 2.0
    n_nodes = pts.shape[1]
    names = list(node_names) if node_names else [str(i) for i in range(n_nodes)]
    box_data = []
    for i in range(pts.shape[0]):
        for k in range(n_nodes):
            x, y = pts[i, k]
            if np.isnan(x) or np.isnan(y):
                continue
            score = float(conf[i, k]) if conf is not None else 1.0
            if conf is not None and score < confmap_threshold:
                continue
            box_data.append({
                "position": {
                    "minX": float(x - half), "maxX": float(x + half),
                    "minY": float(y - half), "maxY": float(y + half),
                },
                "domain": "pixel",
                "class_id": k,
                "box_caption": names[k] if k < len(names) else str(k),
                "scores": {"confidence": score},
            })
    return {
        "predictions": {
            "box_data": box_data,
            "class_labels": {i: n for i, n in enumerate(names)},
        }
    }


class WandbLoggerCallback(Callback):
    """Log per-epoch metrics to wandb (or a local offline run directory)."""

    def __init__(self, trainer):
        self.trainer = trainer
        self.run = None
        self._is_wandb = False

    # -- lifecycle -------------------------------------------------------------
    def on_train_start(self, trainer):
        cfg = trainer.config.trainer_config
        wb = cfg.wandb
        run_config = {
            "model_type": trainer.model_type,
            "run_name": cfg.run_name,
            "config": trainer.config.to_dict()
            if hasattr(trainer.config, "to_dict")
            else str(trainer.config),
        }
        try:
            import wandb  # noqa: F401 — optional dependency
        except ImportError:
            warnings.warn(
                "use_wandb is enabled but the `wandb` package is not "
                "installed; logging metrics to a local offline run directory "
                "under the checkpoint dir instead.",
                stacklevel=2,
            )
            run_id = wb.prv_runid or time.strftime("%Y%m%d_%H%M%S")
            root = (trainer.ckpt_dir or Path(".")) / "wandb"
            self.run = _LocalRun(root, run_id, run_config)
        else:
            if wb.api_key:
                wandb.login(key=wb.api_key)
            self.run = wandb.init(
                entity=wb.entity,
                project=wb.project,
                name=wb.name or cfg.run_name,
                group=wb.group,
                mode=wb.wandb_mode or None,
                id=wb.prv_runid,
                resume="allow" if wb.prv_runid else None,
                config=run_config,
                dir=str(trainer.ckpt_dir) if trainer.ckpt_dir else None,
            )
            self._is_wandb = True
            # Epoch is the x-axis for everything.
            wandb.define_metric("epoch")
            for pattern in ("train/*", "val/*", "learning_rate"):
                wandb.define_metric(pattern, step_metric="epoch")
        wb.current_run_id = self.run.id
        trainer.wandb_url = getattr(self.run, "url", None)

    def on_epoch_end(self, trainer, epoch: int, logs: Dict):
        if self.run is None:
            return
        payload = {"epoch": epoch, **logs}
        self.run.log(payload)
        wb = trainer.config.trainer_config.wandb
        if (
            wb.save_viz_imgs_wandb
            and getattr(wb, "viz_enabled", True)
            and trainer.ckpt_dir is not None
        ):
            viz_dir = trainer.ckpt_dir / "viz"
            if viz_dir.exists():
                # VizCallback writes <viz_dir>/epoch_{epoch:04d}.<fmt> plus
                # the _pafs/_classmaps panels — upload all of them.
                for png in sorted(viz_dir.glob(f"epoch_{epoch:04d}*")):
                    self.run.save(str(png))
        if wb.viz_boxes or wb.viz_masks or wb.log_viz_table:
            try:
                self._log_viz_overlays(trainer, epoch, wb)
            except Exception as e:  # viz must never break training
                print(f"wandb viz overlay failed at epoch {epoch}: {e}")

    def _log_viz_overlays(self, trainer, epoch: int, wb):
        """Box / mask overlay images and the optional table row, from the
        epoch's viz sample (rendered once per epoch, shared with
        ``VizCallback``)."""
        import numpy as np
        import torch

        from sleap_nn_tpu_torch.ops.peaks import find_local_peaks
        from sleap_nn_tpu_torch.training.viz import VizCallback

        processed, preds = VizCallback.sample(trainer, epoch)
        img = processed["image"][0].float().cpu().numpy()
        payload = {}
        if wb.viz_boxes:
            cm_head = next((h for h in trainer.model.heads if "Confmaps" in h.name), None)
            if cm_head is not None:
                with torch.no_grad():
                    pts, vals, _, valid = find_local_peaks(
                        preds[cm_head.name][:1], threshold=wb.viz_confmap_threshold,
                        max_peaks=20)
                keep = valid[0].cpu().numpy()
                boxes = peaks_to_boxes(
                    pts[0].cpu().numpy()[keep] * cm_head.output_stride,
                    vals[0].cpu().numpy()[keep],
                    box_size=wb.viz_box_size,
                    confmap_threshold=wb.viz_confmap_threshold,
                )
                payload["viz/boxes"] = self._wandb_image(img, boxes=boxes)
        if wb.viz_masks:
            seg_head = next((h for h in trainer.model.heads if "Segmentation" in h.name), None)
            if seg_head is not None:
                fg = (torch.sigmoid(preds[seg_head.name][0, ..., 0].float()) > 0.5)
                payload["viz/masks"] = self._wandb_image(
                    img,
                    masks={"predictions": {
                        "mask_data": fg.cpu().numpy().astype(np.uint8),
                        "class_labels": {0: "background", 1: "foreground"},
                    }},
                )
        if payload:
            self.run.log({"epoch": epoch, **payload})
        if wb.log_viz_table:
            self._table_rows = getattr(self, "_table_rows", [])
            self._table_rows.append([epoch, self._wandb_image(img)])

    def _wandb_image(self, img, **kwargs):
        """wandb.Image when live; the raw payload dict offline/stubbed."""
        if self._is_wandb:
            import wandb

            return wandb.Image(img, **kwargs)
        return {"image_shape": list(getattr(img, "shape", [])), **kwargs}

    def on_train_end(self, trainer):
        if self.run is None:
            return
        rows = getattr(self, "_table_rows", None)
        if rows:
            # log_viz_table: one table with every epoch's sample image.
            if self._is_wandb:
                import wandb

                self.run.log({"viz/table": wandb.Table(
                    columns=["epoch", "image"], data=rows)})
            else:
                self.run.log({"viz/table_rows": len(rows)})
        summary = {
            "best_val_loss": float(getattr(trainer, "best_val_loss", float("nan"))),
            "epochs": int(getattr(trainer, "current_epoch", -1)) + 1,
        }
        if self._is_wandb:
            for key, value in summary.items():
                self.run.summary[key] = value
            self.run.finish()
            # delete_local_logs (WandbConfig): drop the synced
            # local wandb dir after the run finishes uploading.
            wb = trainer.config.trainer_config.wandb
            if getattr(wb, "delete_local_logs", None) and trainer.ckpt_dir:
                import shutil

                shutil.rmtree(trainer.ckpt_dir / "wandb", ignore_errors=True)
        else:
            self.run.finish(summary)
        self.run = None

    def close(self):
        if self.run is not None:
            try:
                self.run.finish()
            except Exception:
                pass
            self.run = None
