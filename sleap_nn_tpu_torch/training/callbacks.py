"""Training callbacks: CSV logging, early stopping, progress, epoch-end
evaluation.

Port of the GUI-independent callbacks of
``sleap_nn_tpu/training/callbacks.py``. The ZMQ controller and reporter
are not ported yet, nor the epoch-end evaluation of segmentation models
(ROADMAP.md section 1, item 10).
"""

from __future__ import annotations

import csv
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


class EpochEndEvaluationCallback(Callback):
    """OKS and distance evaluation on the val set every ``frequency`` epochs.

    Renders each val batch without augmentation, runs the model under
    ``torch.no_grad()`` in eval mode (and restores the mode), finds peaks
    on the confidence maps (global peaks with integral refinement for the
    single-instance, centered-instance and multi-class top-down models;
    local peaks, at most 20, for the centroid model) and adds ``val/mOKS``, ``val/dist.avg`` and,
    for the centroid model, ``val/detection.f1`` to the epoch logs (and so
    to the CSV row). Other model types add nothing. A failure is printed,
    never raised: evaluation must not stop training.
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

    def _evaluate(self, trainer) -> Dict:
        # The trainer's eval_loader: the whole val set, also where each
        # rank of a data-parallel run validates on its own rows.
        mtype = trainer.model_type
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
