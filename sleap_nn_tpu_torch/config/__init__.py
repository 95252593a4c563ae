"""Config dataclasses (copies of the JAX package's schema) and their helpers."""

from sleap_nn_tpu_torch.config.base import (
    apply_overrides,
    from_dict,
    load_yaml,
    save_yaml,
    to_dict,
    to_yaml,
)
from sleap_nn_tpu_torch.config.data_config import (
    AugmentationConfig,
    DataConfig,
    GeometricConfig,
    IntensityConfig,
    PreprocessingConfig,
    TilingConfig,
)
from sleap_nn_tpu_torch.config.model_config import (
    BackboneConfig,
    BottomUpConfig,
    CenteredInstanceConfig,
    CentroidConfig,
    ConvNextConfig,
    HeadConfig,
    ModelConfig,
    PAFConfig,
    SingleInstanceConfig,
    SwinTConfig,
    UNetConfig,
)
from sleap_nn_tpu_torch.config.trainer_config import (
    EarlyStoppingConfig,
    EvalConfig,
    LRSchedulerConfig,
    OptimizerConfig,
    TrainerConfig,
    ZMQConfig,
)
from sleap_nn_tpu_torch.config.training_job_config import (
    TrainingJobConfig,
    verify_training_cfg,
)
from sleap_nn_tpu_torch.config.utils import (
    check_output_strides,
    get_backbone_config,
    get_backbone_type_from_cfg,
    get_head_config,
    get_model_type_from_cfg,
    resolve_model_dir,
)

__all__ = [
    "DataConfig", "ModelConfig", "TrainerConfig", "TrainingJobConfig", "apply_overrides",
    "check_output_strides", "from_dict", "get_backbone_config", "get_backbone_type_from_cfg",
    "get_head_config", "get_model_type_from_cfg", "load_yaml", "resolve_model_dir",
    "save_yaml", "to_dict", "to_yaml", "verify_training_cfg",
]
