"""Training entry points: a training job, then the post-training evaluation
of each split (port of ``sleap_nn_tpu/train.py``).

The model directory the trainer writes loads with
``inference.loaders.load_model``. After training, each train, val and test
split is predicted with ``inference.run.predict`` and scored with
``evaluation.run_evaluation``: ``labels_pr.{split}_{i}.slp`` and
``metrics.{split}.{i}.npz`` in the model dir, as the JAX package writes
them.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional

from sleap_nn_tpu_torch.config import TrainingJobConfig
from sleap_nn_tpu_torch.evaluation import run_evaluation
from sleap_nn_tpu_torch.io.model import Labels
from sleap_nn_tpu_torch.training import ModelTrainer


def _eval_split(
    model_dir: Path,
    model_type: str,
    split: str,
    idx: int,
    labels_gt,
    peak_threshold: float = 0.2,
    device="cuda",
) -> Optional[dict]:
    """Predict a split's ground-truth frames and evaluate the predictions:
    ``labels_pr.{split}_{idx}.slp`` and ``metrics.{split}.{idx}.npz`` in
    ``model_dir``. A centered-instance model alone cannot run top-down, so
    its splits are skipped (None), as in the JAX package."""
    from sleap_nn_tpu_torch.inference.run import predict

    if model_type == "centered_instance":
        return None
    match_method = "centroid" if model_type == "centroid" else "oks"
    preds = predict(labels_gt, [str(model_dir)], make_labels=True,
                    peak_threshold=peak_threshold, device=device)
    preds.save(model_dir / f"labels_pr.{split}_{idx}.slp")
    return run_evaluation(labels_gt, preds, match_method=match_method,
                          save_metrics=str(model_dir / f"metrics.{split}.{idx}.npz"))


def run_training(config: TrainingJobConfig, train_labels: Optional[List[Labels]] = None,
                 val_labels: Optional[List[Labels]] = None, device="cuda") -> ModelTrainer:
    """Train a model from ``config``, then evaluate each split, best effort.

    Labels come in memory, else from the config's ``train_labels_path`` /
    ``val_labels_path``; ``data_config.test_file_path`` adds test splits.
    Returns the trainer (with ``.history`` and ``.ckpt_dir``). It trains
    and predicts on the card unless ``device="cpu"``. Where the trainer
    runs data-parallel over processes it spawned, this returns rank 0's
    trainer once every rank has finished; under the launch variables each
    process returns its own, and only rank 0 evaluates.
    """
    trainer = ModelTrainer.get_model_trainer_from_config(
        config, train_labels, val_labels, device=device)
    trainer.train()

    # Rank 0 alone evaluates a data-parallel run.
    if trainer.ckpt_dir is not None and trainer.rank == 0:
        test_labels: List = []
        tfp = config.data_config.test_file_path
        if tfp:
            from sleap_nn_tpu_torch.io.slp import load_slp

            paths = [tfp] if isinstance(tfp, (str, Path)) else list(tfp)
            for p in paths:
                try:
                    test_labels.append(load_slp(str(p)))
                except Exception as e:
                    print(f"test_file_path {p}: failed to load ({e})")
        for split, labels_list in (
            ("train", trainer.train_labels),
            ("val", trainer.val_labels),
            ("test", test_labels),
        ):
            for i, labels in enumerate(labels_list):
                try:
                    m = _eval_split(trainer.ckpt_dir, trainer.model_type, split, i, labels,
                                    device=str(trainer.device))
                    if m is None:
                        print(f"eval {split}_{i}: no usable predictions, metrics skipped")
                    elif "mOKS" in m:
                        print(f"eval {split}_{i}: mOKS={m['mOKS']['mOKS']:.4f}")
                except Exception as e:  # best effort, as in the JAX package
                    print(f"Post-training eval failed for {split}_{i}: {e}")
    return trainer


def train(
    train_labels_path: Optional[List[str]] = None,
    config_path: Optional[str] = None,
    overrides: Optional[Dict] = None,
    **kwargs,
) -> ModelTrainer:
    """Train from a YAML config: ``config_path`` loaded with ``overrides``,
    ``train_labels_path`` (one path or a list) in place of the config's,
    and each keyword argument set on ``trainer_config``; then
    :func:`run_training`, on the card, or on the CPU where
    ``trainer_config.trainer_accelerator`` is ``"cpu"`` (the JAX trainer's
    switch to its CPU backend).

    Without ``config_path`` the JAX package builds the config from keyword
    arguments (``config/get_config.py``), which is not ported (ROADMAP.md
    section 1, item 13b): that raises ``NotImplementedError``.
    """
    if config_path is None:
        raise NotImplementedError(
            "train() without config_path builds the config from keyword arguments through "
            "config/get_config.py, which is not ported (ROADMAP.md section 1, item 13b): "
            "pass config_path")
    config = TrainingJobConfig.load_yaml(config_path, overrides=overrides)
    if train_labels_path:
        config.data_config.train_labels_path = (
            [train_labels_path] if isinstance(train_labels_path, (str, Path))
            else list(train_labels_path))
    for key, value in kwargs.items():
        setattr(config.trainer_config, key, value)
    accel = (config.trainer_config.trainer_accelerator or "auto").lower()
    return run_training(config, device="cpu" if accel == "cpu" else "cuda")
