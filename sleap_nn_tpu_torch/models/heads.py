"""Model output heads for the ported model types.

Port of the confidence-map and part-affinity-field heads of
``sleap_nn_tpu/models/heads.py``: the head descriptors (frozen dataclasses
keyed by ``name``) and the 1x1 conv head layer. The layer is an ``nn.Sequential`` whose conv sits at index 0,
so a model's keys read ``head_layers.{i}.{HeadName}.0.{weight|bias}`` as
in reference checkpoints.
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


@dataclass(frozen=True)
class Head:
    """Base head descriptor."""

    output_stride: int = 1
    loss_weight: float = 1.0

    def __post_init__(self):
        # Tuples all the way down, so a head is hashable like the JAX one.
        for attr in ("part_names", "edges"):
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
