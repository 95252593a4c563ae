"""Auto-configuration: dataset analysis -> recommendations -> a training config.

Port of ``sleap_nn_tpu/config_generator/``: the analysis, the
recommendation, the memory and architecture estimates, the generator
(:func:`generate_config`, which ``config --auto`` and ``config-generate``
run) and the interactive front end (:mod:`.tui`, curses or plain prompts).
"""

from sleap_nn_tpu_torch.config_generator.analyzer import DatasetStats, analyze_slp
from sleap_nn_tpu_torch.config_generator.architecture_estimates import (
    compute_backbone_context_margin,
    compute_max_stride_for_animal_size,
    compute_receptive_field,
    compute_suggested_crop_size,
    compute_suggested_tile_overlap,
    compute_suggested_tile_size,
    estimate_unet_params,
    recommend_default_max_stride,
)
from sleap_nn_tpu_torch.config_generator.memory import MemoryEstimate, estimate_memory
from sleap_nn_tpu_torch.config_generator.recommender import (
    ConfigRecommendation,
    PipelineRecommendation,
    recommend_config,
    recommend_pipeline,
)
from sleap_nn_tpu_torch.config_generator.generator import generate_config

__all__ = [
    "DatasetStats",
    "analyze_slp",
    "recommend_pipeline",
    "recommend_config",
    "PipelineRecommendation",
    "ConfigRecommendation",
    "MemoryEstimate",
    "estimate_memory",
    "compute_receptive_field",
    "compute_max_stride_for_animal_size",
    "recommend_default_max_stride",
    "estimate_unet_params",
    "compute_suggested_crop_size",
    "compute_suggested_tile_size",
    "compute_suggested_tile_overlap",
    "compute_backbone_context_margin",
    "generate_config",
]
