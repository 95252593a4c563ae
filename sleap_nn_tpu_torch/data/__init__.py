"""Host and device data handling: preprocessing, augmentation, the training pipeline.

The public names are the JAX package's, imported on first use, so
``import sleap_nn_tpu_torch.data`` imports no torch.
"""

from sleap_nn_tpu_torch._lazy import reexports

__all__, __getattr__, __dir__ = reexports(__name__, {
    "providers": ("get_max_height_width", "get_max_instances", "process_lf"),
    "normalization": ("ensure_grayscale", "ensure_rgb", "normalize_image"),
    "resizing": ("apply_pad_to_stride", "apply_resizer", "apply_sizematcher",
                 "find_padding_for_stride"),
    "instance_centroids": ("generate_centroids",),
    "instance_cropping": ("find_instance_crop_size",),
})
