"""Model output heads for the ported model types.

Port of the confidence-map, part-affinity-field, class-map,
class-vector and segmentation (foreground, instance centre and centre
offset) heads of ``sleap_nn_tpu/models/heads.py``: the head
descriptors (frozen dataclasses keyed by ``name``), the 1x1 conv head
layer and the class-vectors layer. The conv layer is an
``nn.Sequential`` whose conv sits at index 0, so a model's keys read
``head_layers.{i}.{HeadName}.0.{weight|bias}`` as in reference
checkpoints; the class-vectors layer holds its dense layers as
``head_layers.{i}.pre_classification{j}_fc`` and
``head_layers.{i}.ClassVectorsHead`` (the logits).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import torch
from torch import nn

from sleap_nn_tpu_torch.models.encoder_decoder import conv_nhwc, get_act_fn


class ConvHeadLayer(nn.Sequential):
    """1x1 conv + activation head layer (NHWC in and out)."""

    def __init__(self, in_channels: int, channels: int, activation: str = "identity"):
        super().__init__(nn.Conv2d(in_channels, channels, 1))
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return get_act_fn(self.activation)(conv_nhwc(self[0], x))


class ClassVectorsHeadLayer(nn.ModuleDict):
    """Global max pool (or an NHWC flatten) -> ``fc{j}`` Dense + relu ->
    logits Dense -> softmax, on the backbone's ``intermediate_feat``.

    ``in_features``: the feature's channels with ``global_pool``, else
    ``H * W * C`` of the feature (flattened in NHWC order, as the JAX
    package flattens it).
    """

    def __init__(self, in_features: int, channels: int, num_fc_layers: int = 1,
                 num_fc_units: int = 64, global_pool: bool = True):
        layers = {}
        for j in range(num_fc_layers):
            layers[f"pre_classification{j}_fc"] = nn.Linear(in_features, num_fc_units)
            in_features = num_fc_units
        layers["ClassVectorsHead"] = nn.Linear(in_features, channels)
        super().__init__(layers)
        self.num_fc_layers = num_fc_layers
        self.global_pool = global_pool

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.amax(dim=(1, 2)) if self.global_pool else x.reshape(x.shape[0], -1)
        for j in range(self.num_fc_layers):
            x = torch.relu(self[f"pre_classification{j}_fc"](x))
        return torch.softmax(self["ClassVectorsHead"](x), dim=-1)


@dataclass(frozen=True)
class Head:
    """Base head descriptor."""

    output_stride: int = 1
    loss_weight: float = 1.0

    def __post_init__(self):
        # Tuples all the way down, so a head is hashable like the JAX one.
        for attr in ("part_names", "edges", "classes"):
            val = getattr(self, attr, None)
            if val is not None and not isinstance(val, tuple):
                object.__setattr__(self, attr, tuple(
                    tuple(v) if isinstance(v, (list, tuple)) else v for v in val))

    @property
    def name(self) -> str:
        return type(self).__name__

    @property
    def channels(self) -> int:
        raise NotImplementedError

    @property
    def activation(self) -> str:
        return "identity"

    @property
    def loss_function(self) -> str:
        return "mse"

    def make_layer(self, in_channels: int) -> nn.Module:
        return ConvHeadLayer(in_channels, self.channels, self.activation)


@dataclass(frozen=True)
class SingleInstanceConfmapsHead(Head):
    part_names: Sequence[str] = ()
    sigma: float = 5.0

    @property
    def channels(self) -> int:
        return len(self.part_names)


@dataclass(frozen=True)
class CentroidConfmapsHead(Head):
    anchor_part: Optional[str] = None
    sigma: float = 5.0

    @property
    def channels(self) -> int:
        return 1


@dataclass(frozen=True)
class CenteredInstanceConfmapsHead(Head):
    part_names: Sequence[str] = ()
    anchor_part: Optional[str] = None
    sigma: float = 5.0

    @property
    def channels(self) -> int:
        return len(self.part_names)


@dataclass(frozen=True)
class MultiInstanceConfmapsHead(Head):
    part_names: Sequence[str] = ()
    sigma: float = 5.0

    @property
    def channels(self) -> int:
        return len(self.part_names)


@dataclass(frozen=True)
class PartAffinityFieldsHead(Head):
    edges: Sequence = ()
    sigma: float = 15.0

    @property
    def channels(self) -> int:
        return 2 * len(self.edges)


@dataclass(frozen=True)
class ClassMapsHead(Head):
    classes: Sequence[str] = ()
    sigma: float = 5.0

    @property
    def channels(self) -> int:
        return len(self.classes)

    @property
    def activation(self) -> str:
        return "sigmoid"


@dataclass(frozen=True)
class ClassVectorsHead(Head):
    """Class probabilities of the whole input (one vector per crop), from
    the backbone's ``intermediate_feat`` rather than a decoder stride."""

    classes: Sequence[str] = ()
    num_fc_layers: int = 1
    num_fc_units: int = 64
    global_pool: bool = True

    @property
    def channels(self) -> int:
        return len(self.classes)

    @property
    def activation(self) -> str:
        return "softmax"

    @property
    def loss_function(self) -> str:
        return "categorical_crossentropy"

    def make_layer(self, in_channels: int) -> nn.Module:
        """``in_channels``: the dense input size (see ``ClassVectorsHeadLayer``)."""
        return ClassVectorsHeadLayer(in_channels, self.channels, self.num_fc_layers,
                                     self.num_fc_units, self.global_pool)


@dataclass(frozen=True)
class SegmentationHead(Head):
    """Foreground probability (sigmoid), trained with BCE plus Dice."""

    output_stride: int = 2
    bce_weight: float = 0.5
    dice_weight: float = 0.5
    bce_pos_weight: Optional[float] = None

    @property
    def channels(self) -> int:
        return 1

    @property
    def activation(self) -> str:
        return "sigmoid"

    @property
    def loss_function(self) -> str:
        return "bce_dice"


@dataclass(frozen=True)
class InstanceCenterHead(Head):
    """Heatmap of instance centres (the mask centroids)."""

    output_stride: int = 2
    sigma: float = 4.0

    @property
    def channels(self) -> int:
        return 1


@dataclass(frozen=True)
class CenterOffsetHead(Head):
    """Per-pixel ``(dx, dy)`` to the pixel's instance centre, trained with a
    masked smooth L1."""

    output_stride: int = 2
    loss_weight: float = 0.1

    @property
    def channels(self) -> int:
        return 2

    @property
    def loss_function(self) -> str:
        return "smooth_l1"
