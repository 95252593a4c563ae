"""Ported model definitions: the UNet, ConvNeXt, SwinT and pretrained
backbones, the heads and their assembly.

The public names are the JAX package's (less ``OffsetRefinementHead``,
which it never builds), imported on first use, so
``import sleap_nn_tpu_torch.models`` imports no torch.
"""

from sleap_nn_tpu_torch._lazy import reexports

__all__, __getattr__, __dir__ = reexports(__name__, {
    "heads": ("CenteredInstanceConfmapsHead", "CenterOffsetHead", "CentroidConfmapsHead",
              "ClassMapsHead", "ClassVectorsHead", "Head", "InstanceCenterHead",
              "MultiInstanceConfmapsHead", "PartAffinityFieldsHead", "SegmentationHead",
              "SingleInstanceConfmapsHead"),
    "model": ("MODEL_TYPES", "Model", "get_backbone", "get_head"),
    "unet": ("UNet",),
})
