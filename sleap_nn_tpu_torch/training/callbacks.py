"""Training callbacks: CSV logging, early stopping, progress, the ZMQ GUI
protocol, epoch-end evaluation.

Port of ``sleap_nn_tpu/training/callbacks.py``. The ZMQ messages (JSON
dicts with ``what`` / ``event`` / ``logs`` published on a PUB socket;
``{"command": "stop"}`` and ``{"command": "set_lr", "lr": x}`` read from a
SUB socket) are the SLEAP GUI's contract, kept exactly: the same events,
keys and order. ``zmq`` is imported where a socket is made.
"""

from __future__ import annotations

import csv
import json
import math
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from sleap_nn_tpu_torch.evaluation import compute_oks, match_centroids
from sleap_nn_tpu_torch.ops.peaks import find_global_peaks, find_local_peaks


class Callback:
    """Minimal callback protocol for the training loop."""

    def on_train_start(self, trainer):
        pass

    def on_train_end(self, trainer):
        pass

    def on_epoch_start(self, trainer, epoch: int):
        pass

    def on_epoch_end(self, trainer, epoch: int, logs: Dict):
        pass

    def on_batch_start(self, trainer, batch_idx: int):
        pass

    def on_batch_end(self, trainer, batch_idx: int, logs: Dict):
        pass


class CSVLoggerCallback(Callback):
    """Write one row per epoch to ``training_log.csv``: ``epoch`` and the
    sorted log keys (columns grow as keys appear; the file is rewritten)."""

    def __init__(self, path, keys: Optional[List[str]] = None):
        self.path = Path(path)
        self.keys = keys
        self._fixed_keys = keys is not None
        self._rows: List[Dict] = []

    def on_epoch_end(self, trainer, epoch: int, logs: Dict):
        logs = dict(logs, epoch=epoch)
        self._rows.append(logs)
        if not self._fixed_keys:
            seen = {k for r in self._rows for k in r if k != "epoch"}
            self.keys = ["epoch"] + sorted(seen)
        with open(self.path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(self.keys)
            for r in self._rows:
                w.writerow([r.get(k, "") for k in self.keys])


class EarlyStopping(Callback):
    """Stop when ``monitor`` has not improved by ``min_delta`` for
    ``patience`` epochs."""

    def __init__(
        self,
        monitor: str = "val/loss",
        min_delta: float = 1e-8,
        patience: int = 10,
        enabled: bool = True,
    ):
        self.monitor = monitor
        self.min_delta = min_delta
        self.patience = patience
        self.enabled = enabled
        self.best = math.inf
        self.wait = 0

    def on_epoch_end(self, trainer, epoch: int, logs: Dict):
        if not self.enabled:
            return
        current = logs.get(self.monitor)
        if current is None:
            return
        if current < self.best - self.min_delta:
            self.best = current
            self.wait = 0
        else:
            self.wait += 1
            if self.wait >= self.patience:
                trainer.should_stop = True


class ProgressCallback(Callback):
    """One stdout line per epoch: the numeric logs and the epoch's seconds."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._t0 = None

    def on_epoch_start(self, trainer, epoch: int):
        self._t0 = time.perf_counter()

    def on_epoch_end(self, trainer, epoch: int, logs: Dict):
        if not self.enabled:
            return
        dt = time.perf_counter() - (self._t0 or time.perf_counter())
        msg = f"Epoch {epoch}: " + ", ".join(
            f"{k}={v:.5g}" for k, v in sorted(logs.items()) if isinstance(v, (int, float))
        )
        print(f"{msg} ({dt:.1f}s)", flush=True)


class TrainingControllerZMQ(Callback):
    """SUB socket for the GUI's commands, polled after each batch:
    ``{"command": "stop"}`` stops training at this batch; ``{"command":
    "set_lr", "lr": x}`` sets ``trainer.lr_override``, which the trainer
    applies at the end of the epoch."""

    def __init__(self, address="tcp://127.0.0.1:9000", topic="", poll_timeout=10):
        import zmq

        self.address = address
        self.timeout = poll_timeout
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.SUB)
        self.socket.subscribe(topic)
        self.socket.connect(self.address)
        self._zmq = zmq

    def close(self):
        self.socket.close()
        self.context.term()

    def on_batch_end(self, trainer, batch_idx: int, logs: Dict):
        if self.socket.poll(self.timeout, self._zmq.POLLIN):
            msg = json.loads(self.socket.recv_string())
            if msg.get("command") == "stop":
                trainer.should_stop = True
            elif msg.get("command") == "set_lr":
                trainer.lr_override = float(msg["lr"])


class ProgressReporterZMQ(Callback):
    """PUB socket publishing the run's events for the GUI: ``train_begin``,
    ``epoch_begin``, ``batch_start``, ``batch_end``, ``epoch_end``,
    ``train_end``."""

    def __init__(self, address="tcp://127.0.0.1:9001", what=""):
        import zmq

        self.address = address
        self.what = what
        self.context = zmq.Context()
        self.socket = self.context.socket(zmq.PUB)
        self.socket.connect(self.address)
        self._zmq = zmq

    def close(self):
        self.socket.setsockopt(self._zmq.LINGER, 0)
        self.socket.close()
        self.context.term()

    def send(self, event: str, logs=None, **kwargs):
        msg = dict(what=self.what, event=event, logs=logs, **kwargs)
        self.socket.send_string(json.dumps(msg))

    def on_train_start(self, trainer):
        self.send("train_begin", wandb_url=None)

    def on_train_end(self, trainer):
        self.send("train_end")

    def on_epoch_start(self, trainer, epoch: int):
        self.send("epoch_begin", epoch=epoch)

    def on_epoch_end(self, trainer, epoch: int, logs: Dict):
        self.send("epoch_end", epoch=epoch, logs=_sanitize(logs))

    def on_batch_start(self, trainer, batch_idx: int):
        self.send("batch_start", batch=batch_idx)

    def on_batch_end(self, trainer, batch_idx: int, logs: Dict):
        self.send("batch_end", epoch=trainer.current_epoch, batch=batch_idx,
                  logs=_sanitize(logs))


def _sanitize(logs: Dict) -> Dict:
    """Log values as JSON floats where they convert."""
    out = {}
    for k, v in (logs or {}).items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError):
            out[k] = v
    return out


class EpochEndEvaluationCallback(Callback):
    """OKS and distance evaluation on the val set every ``frequency`` epochs.

    Renders each val batch without augmentation, runs the model under
    ``torch.no_grad()`` in eval mode (and restores the mode), finds peaks
    on the confidence maps (global peaks with integral refinement for the
    single-instance, centered-instance and multi-class top-down models;
    local peaks, at most 20, for the centroid model) and adds ``val/mOKS``, ``val/dist.avg`` and,
    for the centroid model, ``val/detection.f1`` to the epoch logs (and so
    to the CSV row). The segmentation types add ``val/fg_iou``: the
    foreground IoU of ``sigmoid(SegmentationHead) > 0.5`` against the
    rendered target over the real rows of the whole val set. The head's
    output is a probability already, so this sigmoid is a second one, as
    in the JAX package: it lies in (0.5, 0.731), so every pixel counts as
    foreground (ROADMAP.md section 3). Other model types add nothing. A
    failure is
    printed, never raised: evaluation must not stop training.
    """

    def __init__(self, trainer, frequency: int = 1, oks_stddev: float = 0.025,
                 match_threshold: float = 50.0, peak_threshold: float = 0.2):
        self.trainer = trainer
        self.frequency = max(int(frequency), 1)
        self.oks_stddev = oks_stddev
        self.match_threshold = match_threshold
        self.peak_threshold = peak_threshold

    def on_epoch_end(self, trainer, epoch: int, logs: Dict):
        if (epoch + 1) % self.frequency:
            return
        try:
            logs.update(self._evaluate(trainer))
        except Exception as e:  # eval must never break training
            print(f"epoch-end eval failed at epoch {epoch}: {e}")

    @staticmethod
    def _evaluate_segmentation(trainer) -> Dict:
        inter = union = 0.0
        was_training = trainer.model.training
        trainer.model.eval()
        try:
            for batch in getattr(trainer, "eval_loader", trainer.val_loader):
                with torch.no_grad():
                    processed = trainer.render(batch, train=False)
                    probs = trainer.model(processed["image"])["SegmentationHead"][..., 0]
                    fg = (torch.sigmoid(probs) > 0.5).cpu().numpy()
                    gt = (processed["segmentation"][..., 0] > 0.5).cpu().numpy()
                mask = np.asarray(batch["batch_mask"], bool)
                fg, gt = fg[mask], gt[mask]
                inter += float(np.logical_and(fg, gt).sum())
                union += float(np.logical_or(fg, gt).sum())
        finally:
            trainer.model.train(was_training)
        return {"val/fg_iou": inter / union if union else 0.0}

    def _evaluate(self, trainer) -> Dict:
        # The trainer's eval_loader: the whole val set, also where each
        # rank of a data-parallel run validates on its own rows.
        mtype = trainer.model_type
        if mtype in ("bottomup_segmentation", "semantic_segmentation",
                     "centered_instance_segmentation"):
            return self._evaluate_segmentation(trainer)
        if mtype not in ("single_instance", "centered_instance", "multi_class_topdown",
                         "centroid"):
            return {}
        cm_head = next(h for h in trainer.model.heads if "Confmaps" in h.name)
        stride = cm_head.output_stride

        oks_list, dist_list, n_tp = [], [], 0
        n_gt = n_pr = 0
        was_training = trainer.model.training
        trainer.model.eval()
        try:
            for batch in getattr(trainer, "eval_loader", trainer.val_loader):
                with torch.no_grad():
                    processed = trainer.render(batch, train=False)
                    cms = trainer.model(processed["image"])[cm_head.name]
                    if mtype == "centroid":
                        pts, _, _, valid = find_local_peaks(
                            cms, self.peak_threshold, "integral", max_peaks=20)
                        valid = valid.cpu().numpy()
                        gt = processed["centroids"]
                    else:
                        pts, _ = find_global_peaks(cms, self.peak_threshold, "integral")
                        gt = processed["instances"]
                pts = pts.cpu().numpy() * stride
                gt = gt.cpu().numpy()
                mask = np.asarray(batch["batch_mask"])
                if mtype == "centroid":
                    for i in np.nonzero(mask)[0]:
                        g = gt[i][~np.isnan(gt[i][:, 0])]
                        p = pts[i][valid[i]]
                        pairs, fn, fp = match_centroids(g, p, self.match_threshold)
                        n_tp += len(pairs)
                        n_gt += len(g)
                        n_pr += len(p)
                        dist_list.extend(d for _, _, d in pairs)
                elif gt.ndim == 4:  # (B, I, N, 2): compare against each GT instance
                    for i in np.nonzero(mask)[0]:
                        g = gt[i][~np.isnan(gt[i][:, :, 0]).all(axis=-1)]
                        if not len(g):
                            continue
                        oks = compute_oks(g, pts[i][None], stddev=self.oks_stddev)
                        oks_list.append(float(np.nanmax(oks)))
                        best = int(np.nanargmax(oks[:, 0]))
                        dist_list.extend(
                            np.linalg.norm(pts[i] - g[best], axis=-1)[
                                ~np.isnan(g[best][:, 0])
                            ].tolist()
                        )
                else:
                    for i in np.nonzero(mask)[0]:
                        oks = compute_oks(gt[i][None], pts[i][None], stddev=self.oks_stddev)
                        oks_list.append(float(oks[0, 0]))
                        d = np.linalg.norm(pts[i] - gt[i], axis=-1)
                        dist_list.extend(d[~np.isnan(d)].tolist())
        finally:
            trainer.model.train(was_training)

        out: Dict = {}
        if oks_list:
            out["val/mOKS"] = float(np.nanmean(oks_list))
        if dist_list:
            out["val/dist.avg"] = float(np.mean(dist_list))
        if mtype == "centroid" and (n_gt or n_pr):
            precision = n_tp / n_pr if n_pr else 0.0
            recall = n_tp / n_gt if n_gt else 0.0
            out["val/detection.f1"] = (
                2 * precision * recall / (precision + recall)
                if precision + recall
                else 0.0
            )
        return out
