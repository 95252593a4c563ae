"""Config dataclasses (copies of the JAX package's schema) and their helpers."""

from sleap_nn_tpu_torch.config.base import apply_overrides, from_dict, to_dict
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
    "TrainingJobConfig", "apply_overrides", "check_output_strides", "from_dict",
    "get_backbone_config", "get_backbone_type_from_cfg", "get_head_config",
    "get_model_type_from_cfg", "resolve_model_dir", "to_dict", "verify_training_cfg",
]
