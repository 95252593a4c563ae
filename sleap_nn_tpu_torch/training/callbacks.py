"""Training callbacks: CSV logging, early stopping, progress.

Port of the GUI-independent callbacks of
``sleap_nn_tpu/training/callbacks.py``. The ZMQ controller and reporter
and the epoch-end evaluation are not ported yet.
"""

from __future__ import annotations

import csv
import math
import time
from pathlib import Path
from typing import Dict, List, Optional


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
