"""Training entry point (port of ``run_training`` in ``sleap_nn_tpu/train.py``).

The model directory it writes loads with ``inference.loaders.load_model``.
The post-training prediction and evaluation of each split wait for the
evaluation module (ROADMAP.md section 1, item 5).
"""

from __future__ import annotations

from typing import List, Optional

from sleap_nn_tpu_torch.config import TrainingJobConfig
from sleap_nn_tpu_torch.io.model import Labels
from sleap_nn_tpu_torch.training import ModelTrainer


def run_training(config: TrainingJobConfig, train_labels: Optional[List[Labels]] = None,
                 val_labels: Optional[List[Labels]] = None, device="cuda") -> ModelTrainer:
    """Train a model from ``config`` on in-memory labels.

    Returns the trainer (with ``.history`` and ``.ckpt_dir``). It trains on
    the card unless ``device="cpu"``.
    """
    trainer = ModelTrainer.get_model_trainer_from_config(
        config, train_labels, val_labels, device=device)
    trainer.train()
    return trainer
