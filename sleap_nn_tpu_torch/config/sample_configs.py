"""The sample training configs, built from ``get_config`` keyword arguments.

Port of ``sleap_nn_tpu/config/sample_configs.py``: the same named samples
give the same YAML text as the JAX package's (its committed
``docs/sample_configs/*.yaml``). :func:`write_all` writes them into the
directory it is given; it has no default, so nothing here writes into the
repository's docs.

    python -m sleap_nn_tpu_torch.config.sample_configs OUT_DIR
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict

# name -> get_config keyword arguments (the JAX package's set, one for one).
SAMPLES: Dict[str, dict] = {
    "config_single_instance_unet_medium_rf": dict(
        head_configs="single_instance", backbone="unet_medium_rf"),
    "config_single_instance_unet_large_rf": dict(
        head_configs="single_instance", backbone="unet_large_rf"),
    "config_centroid_unet": dict(
        head_configs="centroid", backbone="unet"),
    "config_centroid_unet_standalone": dict(
        # A standalone detector (no crop stage): a tighter sigma, as the
        # config generator recommends for it.
        head_configs={"centroid": {"confmaps": {"sigma": 2.5}}},
        backbone="unet"),
    "config_centroid_swint": dict(
        head_configs="centroid", backbone="swint_tiny"),
    "config_topdown_centered_instance_unet_medium_rf": dict(
        head_configs="centered_instance", backbone="unet_medium_rf", crop_size=160),
    "config_topdown_centered_instance_unet_large_rf": dict(
        head_configs="centered_instance", backbone="unet_large_rf", crop_size=160),
    "config_topdown_multi_class_centered_instance_unet": dict(
        head_configs="multi_class_topdown", backbone="unet", crop_size=160),
    "config_bottomup_unet_medium_rf": dict(
        head_configs="bottomup", backbone="unet_medium_rf"),
    "config_bottomup_unet_large_rf": dict(
        head_configs="bottomup", backbone="unet_large_rf"),
    "config_bottomup_convnext": dict(
        head_configs="bottomup", backbone="convnext_tiny"),
    "config_multi_class_bottomup_unet": dict(
        head_configs="multi_class_bottomup", backbone="unet"),
    "config_bottomup_segmentation_unet": dict(
        head_configs="bottomup_segmentation", backbone="unet"),
    "config_bottomup_segmentation_pretrained": dict(
        head_configs="bottomup_segmentation", backbone="pretrained"),
    "config_topdown_centered_instance_segmentation_unet": dict(
        head_configs="centered_instance_segmentation", backbone="unet", crop_size=160),
    "config_semantic_segmentation_unet": dict(
        head_configs="semantic_segmentation", backbone="unet"),
    # The throughput preset (config_generator.recommender): heads at
    # output stride 4 and a crop of 128.
    "config_topdown_centered_instance_unet_medium_rf_throughput": dict(
        head_configs="centered_instance", backbone="unet_medium_rf",
        output_stride=4, crop_size=128),
}


def build_sample(name: str):
    """One named sample as a verified ``TrainingJobConfig``."""
    from sleap_nn_tpu_torch.config.get_config import get_config
    from sleap_nn_tpu_torch.config.training_job_config import verify_training_cfg

    return verify_training_cfg(get_config(**SAMPLES[name]))


def sample_yaml(name: str) -> str:
    """The YAML text of one named sample."""
    from sleap_nn_tpu_torch.config.base import to_yaml

    return to_yaml(build_sample(name))


def write_all(out_dir) -> Dict[str, Path]:
    """Write every sample as ``<out_dir>/<name>.yaml``; returns name -> path."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    written = {}
    for name in SAMPLES:
        path = out_dir / f"{name}.yaml"
        path.write_text(sample_yaml(name))
        written[name] = path
    return written


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 1:
        print("usage: python -m sleap_nn_tpu_torch.config.sample_configs OUT_DIR",
              file=sys.stderr)
        return 2
    for path in write_all(argv[0]).values():
        print(f"Wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
