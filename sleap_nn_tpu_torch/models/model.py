"""Model assembly: backbone + heads.

Port of ``sleap_nn_tpu/models/model.py`` for the UNet, ConvNeXt, SwinT and
pretrained backbones and the single-instance, centroid, centered-instance,
bottom-up, identity (multi-class) and segmentation heads: ``get_backbone`` /
``get_head`` and the ``Model`` that binds each head's 1x1 conv to the
decoder feature at that head's ``output_stride`` (a class-vectors head to
the backbone's ``intermediate_feat``; every head of an encoder-only
backbone to its ``middle_output``), with gray<->RGB input coercion in
``forward``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from sleap_nn_tpu_torch.models.heads import (
    CenteredInstanceConfmapsHead,
    CenterOffsetHead,
    CentroidConfmapsHead,
    ClassMapsHead,
    ClassVectorsHead,
    Head,
    InstanceCenterHead,
    MultiInstanceConfmapsHead,
    PartAffinityFieldsHead,
    SegmentationHead,
    SingleInstanceConfmapsHead,
)
from sleap_nn_tpu_torch.models.unet import UNet

MODEL_TYPES = ("single_instance", "centroid", "centered_instance", "bottomup",
               "multi_class_bottomup", "multi_class_topdown", "bottomup_segmentation",
               "centered_instance_segmentation", "semantic_segmentation")
_SEG_KEYS = ("output_stride", "loss_weight", "bce_weight", "dice_weight", "bce_pos_weight")


def _cfg_get(cfg, key, default=None):
    """Fetch from dataclass-or-dict configs uniformly."""
    if cfg is None:
        return default
    if isinstance(cfg, dict):
        return cfg.get(key, default)
    return getattr(cfg, key, default)


def get_backbone(backbone_type: str, backbone_config) -> nn.Module:
    """Instantiate a backbone from its config: ``unet``, ``convnext``,
    ``swint`` or ``pretrained``."""
    if backbone_type == "unet":
        return UNet.from_config(backbone_config)
    if backbone_type == "convnext":
        from sleap_nn_tpu_torch.models.convnext import ConvNextWrapper

        return ConvNextWrapper.from_config(backbone_config)
    if backbone_type == "swint":
        from sleap_nn_tpu_torch.models.swint import SwinTWrapper

        return SwinTWrapper.from_config(backbone_config)
    if backbone_type == "pretrained":
        from sleap_nn_tpu_torch.models.pretrained import PretrainedBackbone

        return PretrainedBackbone.from_config(backbone_config)
    raise KeyError(
        f"Unsupported backbone: {backbone_type}. Supported: unet, convnext, swint, pretrained")


def get_head(model_type: str, head_config) -> Tuple[Head, ...]:
    """Instantiate the head set for a model type."""

    def kw(leaf, keys):
        return {k: _cfg_get(leaf, k) for k in keys if _cfg_get(leaf, k) is not None}

    leaf = _cfg_get(head_config, "confmaps")
    if model_type == "bottomup":
        pafs = _cfg_get(head_config, "pafs")
        return (
            MultiInstanceConfmapsHead(
                **kw(leaf, ("part_names", "sigma", "output_stride", "loss_weight"))),
            PartAffinityFieldsHead(
                **kw(pafs, ("edges", "sigma", "output_stride", "loss_weight"))),
        )
    if model_type == "single_instance":
        return (SingleInstanceConfmapsHead(
            **kw(leaf, ("part_names", "sigma", "output_stride", "loss_weight"))),)
    if model_type == "centered_instance":
        return (CenteredInstanceConfmapsHead(
            **kw(leaf, ("part_names", "anchor_part", "sigma", "output_stride", "loss_weight"))),)
    if model_type == "centroid":
        return (CentroidConfmapsHead(
            **kw(leaf, ("anchor_part", "sigma", "output_stride", "loss_weight"))),)
    if model_type == "multi_class_bottomup":
        cmaps = _cfg_get(head_config, "class_maps")
        return (
            MultiInstanceConfmapsHead(
                **kw(leaf, ("part_names", "sigma", "output_stride", "loss_weight"))),
            ClassMapsHead(**kw(cmaps, ("classes", "sigma", "output_stride", "loss_weight"))),
        )
    if model_type == "multi_class_topdown":
        cv = _cfg_get(head_config, "class_vectors")
        return (
            CenteredInstanceConfmapsHead(
                **kw(leaf, ("part_names", "anchor_part", "sigma", "output_stride", "loss_weight"))),
            ClassVectorsHead(**kw(cv, ("classes", "num_fc_layers", "num_fc_units", "global_pool",
                                       "output_stride", "loss_weight"))),
        )
    if model_type == "bottomup_segmentation":
        return (
            SegmentationHead(**kw(_cfg_get(head_config, "segmentation"), _SEG_KEYS)),
            InstanceCenterHead(**kw(_cfg_get(head_config, "center"),
                                    ("sigma", "output_stride", "loss_weight"))),
            CenterOffsetHead(**kw(_cfg_get(head_config, "offsets"),
                                  ("output_stride", "loss_weight"))),
        )
    if model_type in ("centered_instance_segmentation", "semantic_segmentation"):
        return (SegmentationHead(**kw(_cfg_get(head_config, "segmentation"), _SEG_KEYS)),)
    raise ValueError(
        f"{model_type} is not a ported model type. Choose one of {MODEL_TYPES}."
    )


def rgb_to_grayscale(x: torch.Tensor) -> torch.Tensor:
    """ITU-R 601 luma conversion, channel-last."""
    w = torch.tensor([0.2989, 0.587, 0.114], dtype=x.dtype, device=x.device)
    return torch.sum(x * w, dim=-1, keepdim=True)


class Model(nn.Module):
    """Backbone + heads; NHWC input, dict of NHWC head outputs (a
    class-vectors head gives ``(B, n_classes)``).

    ``input_hw``: the network input's (height, width). Only a class-vectors
    head without ``global_pool`` needs it: its first dense layer takes the
    flattened ``intermediate_feat``, whose size follows from the input's.
    """

    def __init__(self, backbone: nn.Module, heads: Tuple[Head, ...], in_channels: int = 1,
                 input_hw: Optional[Tuple[int, int]] = None):
        super().__init__()
        self.backbone = backbone
        self.heads = tuple(heads)
        self.in_channels = in_channels
        stride_to_filters = backbone.stride_to_filters
        layers = []
        for head in self.heads:
            if isinstance(head, ClassVectorsHead):
                # Binds to the bottleneck feature, not a decoder stride.
                layers.append(head.make_layer(self._class_vector_features(head, input_hw)))
                continue
            if not stride_to_filters:
                # An encoder-only backbone: every head binds to middle_output.
                layers.append(nn.ModuleDict(
                    {head.name: head.make_layer(backbone.middle_channels)}))
                continue
            if head.output_stride not in stride_to_filters:
                raise ValueError(
                    f"Head '{head.name}' needs a feature at output_stride "
                    f"{head.output_stride}, but the backbone produces strides "
                    f"{sorted(stride_to_filters)}."
                )
            layers.append(nn.ModuleDict(
                {head.name: head.make_layer(stride_to_filters[head.output_stride])}))
        self.head_layers = nn.ModuleList(layers)

    def _class_vector_features(self, head: ClassVectorsHead,
                               input_hw: Optional[Tuple[int, int]]) -> int:
        stride = self.backbone.max_stride
        channels = self.backbone.bottleneck_channels
        if head.global_pool:
            return channels
        if input_hw is None:
            raise ValueError("a ClassVectorsHead without global_pool needs the model's input_hw "
                             "(its dense input is the flattened bottleneck feature)")
        return (input_hw[0] // stride) * (input_hw[1] // stride) * channels

    @classmethod
    def from_config(cls, backbone_type: str, backbone_config, head_configs,
                    model_type: str, input_hw: Optional[Tuple[int, int]] = None) -> "Model":
        return cls(
            backbone=get_backbone(backbone_type, backbone_config),
            heads=get_head(model_type, head_configs),
            in_channels=_cfg_get(backbone_config, "in_channels", 1),
            input_hw=input_hw,
        )

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if x.shape[-1] != self.in_channels:
            if x.shape[-1] == 1:
                x = x.repeat_interleave(3, dim=-1)
            elif x.shape[-1] == 3:
                x = rgb_to_grayscale(x)
        backbone_outputs = self.backbone(x)
        strides = backbone_outputs["strides"]
        outputs = {}
        for head, layer in zip(self.heads, self.head_layers):
            if not backbone_outputs["outputs"]:
                feature = backbone_outputs["middle_output"]
            elif isinstance(head, ClassVectorsHead):
                feature = backbone_outputs["intermediate_feat"]
            else:
                feature = backbone_outputs["outputs"][strides.index(head.output_stride)]
            if isinstance(head, ClassVectorsHead):
                outputs[head.name] = layer(feature)
            else:
                outputs[head.name] = layer[head.name](feature)
        return outputs


def param_subtree(key: str) -> str:
    """The JAX package's top-level parameter subtree of a ``state_dict``
    key: ``backbone``, or the head's name (a class-vectors head's dense
    layers lie under ``ClassVectorsHead``)."""
    parts = key.split(".")
    if parts[0] == "backbone":
        return "backbone"
    return "ClassVectorsHead" if parts[2].startswith("pre_classification") else parts[2]


def swap_subtrees(own: Dict[str, torch.Tensor], src: Dict[str, torch.Tensor], which: str,
                  missing: str, mismatch: str) -> None:
    """Replace in the ``state_dict`` ``own``, in place, the backbone
    (``which="backbone"``) or every other top-level subtree, the heads
    (``which="head"``), with those of ``src``. A subtree ``src`` lacks
    raises ``ValueError(missing)``, one whose keys or shapes differ
    ``ValueError(mismatch)``; both are formatted with ``which``, the
    subtree's ``name`` and the source's sorted ``trees``."""
    src_trees = sorted({param_subtree(k) for k in src})
    trees = dict.fromkeys(param_subtree(k) for k in own)  # in model order
    names = ["backbone"] if which == "backbone" else [t for t in trees if t != "backbone"]
    for name in names:
        if name not in src_trees:
            raise ValueError(missing.format(which=which, name=name, trees=src_trees))
        shapes = [{k: tuple(v.shape) for k, v in sd.items() if param_subtree(k) == name}
                  for sd in (own, src)]
        if shapes[0] != shapes[1]:
            raise ValueError(mismatch.format(which=which, name=name, trees=src_trees))
        own.update({k: v for k, v in src.items() if param_subtree(k) == name})
