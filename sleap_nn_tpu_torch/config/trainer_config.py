"""Trainer config schema: a copy of ``sleap_nn_tpu/config/trainer_config.py``
(plain data)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass
class DataLoaderConfig:
    batch_size: int = 4
    shuffle: bool = False
    num_workers: int = 0


@dataclass
class TrainDataLoaderConfig(DataLoaderConfig):
    shuffle: bool = True


@dataclass
class ValDataLoaderConfig(DataLoaderConfig):
    shuffle: bool = False


@dataclass
class ModelCkptConfig:
    save_top_k: int = 1
    save_last: Optional[bool] = None
    monitor: str = "val/loss"
    mode: str = "min"


@dataclass
class WandBConfig:
    entity: Optional[str] = None
    project: Optional[str] = None
    name: Optional[str] = None
    save_viz_imgs_wandb: bool = False
    api_key: Optional[str] = None
    wandb_mode: Optional[str] = None
    prv_runid: Optional[str] = None
    group: Optional[str] = None
    current_run_id: Optional[str] = None
    viz_enabled: bool = True
    viz_boxes: bool = False
    viz_masks: bool = False
    viz_box_size: float = 5.0
    viz_confmap_threshold: float = 0.1
    log_viz_table: bool = False
    delete_local_logs: Optional[bool] = None


@dataclass
class OptimizerConfig:
    lr: float = 1e-4
    amsgrad: bool = False


@dataclass
class StepLRConfig:
    step_size: int = 10
    gamma: float = 0.1


@dataclass
class ReduceLROnPlateauConfig:
    threshold: float = 1e-6
    threshold_mode: str = "abs"
    cooldown: int = 3
    patience: int = 5
    factor: float = 0.5
    min_lr: Any = 0.0


@dataclass
class CosineAnnealingWarmupConfig:
    warmup_epochs: int = 5
    max_epochs: Optional[int] = None
    warmup_start_lr: float = 0.0
    eta_min: float = 0.0


@dataclass
class LinearWarmupLinearDecayConfig:
    warmup_epochs: int = 5
    max_epochs: Optional[int] = None
    warmup_start_lr: float = 0.0
    end_lr: float = 0.0


@dataclass
class LRSchedulerConfig:
    step_lr: Optional[StepLRConfig] = None
    reduce_lr_on_plateau: Optional[ReduceLROnPlateauConfig] = None
    cosine_annealing_warmup: Optional[CosineAnnealingWarmupConfig] = None
    linear_warmup_linear_decay: Optional[LinearWarmupLinearDecayConfig] = None


@dataclass
class EarlyStoppingConfig:
    min_delta: float = 1e-8
    patience: int = 10
    stop_training_on_plateau: bool = True


@dataclass
class EvalConfig:
    enabled: bool = False
    frequency: int = 1
    oks_stddev: float = 0.025
    oks_scale: Optional[float] = None
    match_threshold: float = 50.0


@dataclass
class HardKeypointMiningConfig:
    online_mining: bool = False
    hard_to_easy_ratio: float = 2.0
    min_hard_keypoints: int = 2
    max_hard_keypoints: Optional[int] = None
    loss_scale: float = 5.0


@dataclass
class ZMQConfig:
    controller_port: Optional[int] = None
    controller_polling_timeout: int = 10
    publish_port: Optional[int] = None


@dataclass
class TrainerConfig:
    train_data_loader: TrainDataLoaderConfig = field(default_factory=TrainDataLoaderConfig)
    val_data_loader: ValDataLoaderConfig = field(default_factory=ValDataLoaderConfig)
    model_ckpt: ModelCkptConfig = field(default_factory=ModelCkptConfig)
    trainer_devices: Optional[Any] = None
    trainer_device_indices: Optional[List[int]] = None
    trainer_accelerator: str = "auto"
    profiler: Optional[str] = None
    trainer_strategy: str = "auto"
    enable_progress_bar: bool = True
    min_train_steps_per_epoch: int = 200
    train_steps_per_epoch: Optional[int] = None
    visualize_preds_during_training: bool = False
    keep_viz: bool = False
    viz_img_format: str = "png"
    max_epochs: int = 100
    seed: Optional[int] = 42
    use_wandb: bool = False
    save_ckpt: bool = False
    ckpt_dir: Optional[str] = "."
    run_name: Optional[str] = None
    resume_ckpt_path: Optional[str] = None
    wandb: WandBConfig = field(default_factory=WandBConfig)
    optimizer_name: str = "Adam"
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: Optional[LRSchedulerConfig] = field(default_factory=LRSchedulerConfig)
    early_stopping: EarlyStoppingConfig = field(default_factory=EarlyStoppingConfig)
    online_hard_keypoint_mining: Optional[HardKeypointMiningConfig] = field(
        default_factory=HardKeypointMiningConfig
    )
    zmq: Optional[ZMQConfig] = field(default_factory=ZMQConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)
    # TPU-specific (no reference counterpart): evaluate the stride-1 UNet
    # encoder level in space-to-depth packed layout during training — an
    # exact transform with an identical param tree (ops/packed_conv.py).
    # None = auto (on when running on TPU with a stem-less UNet backbone).
    packed_level0: Optional[bool] = None
