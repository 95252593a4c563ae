"""Learning-rate schedulers (host-side, per epoch).

Port of ``sleap_nn_tpu/training/schedulers.py`` (plain Python): each
returns the learning rate for an epoch, which the trainer writes into the
optimizer's ``param_groups`` once per epoch.
"""

from __future__ import annotations

import math
from typing import Optional


class Scheduler:
    """Base: returns the LR for a given epoch; may consume val metrics."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr

    def step(self, epoch: int, val_metric: Optional[float] = None) -> float:
        return self.base_lr


class StepLR(Scheduler):
    def __init__(self, base_lr: float, step_size: int = 10, gamma: float = 0.1):
        super().__init__(base_lr)
        self.step_size = step_size
        self.gamma = gamma

    def step(self, epoch: int, val_metric: Optional[float] = None) -> float:
        return self.base_lr * (self.gamma ** (epoch // self.step_size))


class ReduceLROnPlateau(Scheduler):
    """torch-compatible plateau scheduler (abs/rel threshold, cooldown)."""

    def __init__(
        self,
        base_lr: float,
        factor: float = 0.5,
        patience: int = 5,
        threshold: float = 1e-6,
        threshold_mode: str = "abs",
        cooldown: int = 3,
        min_lr: float = 0.0,
    ):
        super().__init__(base_lr)
        self.lr = base_lr
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr if not isinstance(min_lr, list) else min_lr[0]
        self.best = math.inf
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        if self.threshold_mode == "rel":
            return metric < self.best * (1 - self.threshold)
        return metric < self.best - self.threshold

    def step(self, epoch: int, val_metric: Optional[float] = None) -> float:
        if val_metric is None:
            return self.lr
        if self._is_better(val_metric):
            self.best = val_metric
            self.num_bad_epochs = 0
        else:
            if self.cooldown_counter > 0:
                self.cooldown_counter -= 1
            else:
                self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            self.lr = max(self.lr * self.factor, self.min_lr)
            self.num_bad_epochs = 0
            self.cooldown_counter = self.cooldown
        return self.lr


class LinearWarmupCosineAnnealingLR(Scheduler):
    """Linear warmup then cosine anneal (reference: schedulers.py:11)."""

    def __init__(
        self,
        base_lr: float,
        warmup_epochs: int = 5,
        max_epochs: int = 100,
        warmup_start_lr: float = 0.0,
        eta_min: float = 0.0,
    ):
        super().__init__(base_lr)
        self.warmup_epochs = warmup_epochs
        self.max_epochs = max_epochs
        self.warmup_start_lr = warmup_start_lr
        self.eta_min = eta_min

    def step(self, epoch: int, val_metric: Optional[float] = None) -> float:
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            t = epoch / max(self.warmup_epochs, 1)
            return self.warmup_start_lr + t * (self.base_lr - self.warmup_start_lr)
        t = (epoch - self.warmup_epochs) / max(self.max_epochs - self.warmup_epochs, 1)
        t = min(max(t, 0.0), 1.0)
        return self.eta_min + 0.5 * (self.base_lr - self.eta_min) * (1 + math.cos(math.pi * t))


class LinearWarmupLinearDecayLR(Scheduler):
    """Linear warmup then linear decay (reference: schedulers.py:103)."""

    def __init__(
        self,
        base_lr: float,
        warmup_epochs: int = 5,
        max_epochs: int = 100,
        warmup_start_lr: float = 0.0,
        end_lr: float = 0.0,
    ):
        super().__init__(base_lr)
        self.warmup_epochs = warmup_epochs
        self.max_epochs = max_epochs
        self.warmup_start_lr = warmup_start_lr
        self.end_lr = end_lr

    def step(self, epoch: int, val_metric: Optional[float] = None) -> float:
        if self.warmup_epochs > 0 and epoch < self.warmup_epochs:
            t = epoch / max(self.warmup_epochs, 1)
            return self.warmup_start_lr + t * (self.base_lr - self.warmup_start_lr)
        t = (epoch - self.warmup_epochs) / max(self.max_epochs - self.warmup_epochs, 1)
        t = min(max(t, 0.0), 1.0)
        return self.base_lr + t * (self.end_lr - self.base_lr)


def make_scheduler(lr_cfg, base_lr: float, max_epochs: int) -> Scheduler:
    """Build a scheduler from LRSchedulerConfig (oneof leaves)."""
    if lr_cfg is None:
        return Scheduler(base_lr)
    if lr_cfg.step_lr is not None:
        c = lr_cfg.step_lr
        return StepLR(base_lr, step_size=c.step_size, gamma=c.gamma)
    if lr_cfg.reduce_lr_on_plateau is not None:
        c = lr_cfg.reduce_lr_on_plateau
        return ReduceLROnPlateau(
            base_lr,
            factor=c.factor,
            patience=c.patience,
            threshold=c.threshold,
            threshold_mode=c.threshold_mode,
            cooldown=c.cooldown,
            min_lr=c.min_lr or 0.0,
        )
    if lr_cfg.cosine_annealing_warmup is not None:
        c = lr_cfg.cosine_annealing_warmup
        return LinearWarmupCosineAnnealingLR(
            base_lr,
            warmup_epochs=c.warmup_epochs,
            max_epochs=c.max_epochs or max_epochs,
            warmup_start_lr=c.warmup_start_lr,
            eta_min=c.eta_min,
        )
    if lr_cfg.linear_warmup_linear_decay is not None:
        c = lr_cfg.linear_warmup_linear_decay
        return LinearWarmupLinearDecayLR(
            base_lr,
            warmup_epochs=c.warmup_epochs,
            max_epochs=c.max_epochs or max_epochs,
            warmup_start_lr=c.warmup_start_lr,
            end_lr=c.end_lr,
        )
    return Scheduler(base_lr)
