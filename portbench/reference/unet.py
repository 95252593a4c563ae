"""Plain PyTorch UNet forward of a pose model, from its weights alone.

The benchmark makes the weights (``core/build.py``) and hands the same
tensors to the program and to this reference. The structure is read from
the weights' names and shapes (the naming scheme the models' state dicts
use: ``backbone.encoders.0.encoder_stack.{b}.blocks.stack0_enc{b}_conv{j}``,
``backbone.middle_blocks.{k}...middle_{expand|contract}_conv0``,
``backbone.decoders.0.decoder_stack.{b}...refine_conv{j}`` and
``head_layers.{i}.{Head}.0``), so nothing of the program is imported.

The network, NCHW and float32 unless ``quant`` says otherwise:

- encoder block 0: conv3x3 + relu, twice; blocks 1.. first max-pool 2x2;
  the last block's output is pooled once more;
- middle: one expand and one contract conv3x3 + relu;
- decoder block b: bilinear 2x upsampling with half-pixel centres, the
  encoder feature of the same size concatenated in front, conv3x3 + relu
  twice; block b's output has stride ``max_stride / 2**(b + 1)``;
- each head: a 1x1 conv (no activation) on the decoder output at its stride.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

_ENC = re.compile(r"^backbone\.encoders\.0\.encoder_stack\.(\d+)\.blocks\.stack0_enc\d+_conv(\d+)\.weight$")
_MID = re.compile(r"^backbone\.middle_blocks\.(\d+)\.blocks\.\S+_middle_(expand|contract)_conv0\.weight$")
_DEC = re.compile(r"^backbone\.decoders\.0\.decoder_stack\.(\d+)\.blocks\.\S+_refine_conv(\d+)\.weight$")
_HEAD = re.compile(r"^head_layers\.(\d+)\.(\w+)\.0\.weight$")


@dataclass
class Structure:
    """Weight names of each conv, in the order the forward applies them."""

    encoder: List[List[str]] = field(default_factory=list)
    middle: List[str] = field(default_factory=list)
    decoder: List[List[str]] = field(default_factory=list)
    heads: Dict[str, str] = field(default_factory=dict)  # head name -> weight name

    @property
    def max_stride(self) -> int:
        return 2 ** len(self.encoder)

    def decoder_strides(self) -> List[int]:
        return [self.max_stride // 2 ** (b + 1) for b in range(len(self.decoder))]


def structure(state: Dict[str, torch.Tensor]) -> Structure:
    """The UNet's convs by role, from the weights' names."""
    enc: Dict[int, Dict[int, str]] = {}
    mid: Dict[int, str] = {}
    dec: Dict[int, Dict[int, str]] = {}
    s = Structure()
    for name in state:
        if m := _ENC.match(name):
            enc.setdefault(int(m[1]), {})[int(m[2])] = name
        elif m := _MID.match(name):
            mid[int(m[1])] = name
        elif m := _DEC.match(name):
            dec.setdefault(int(m[1]), {})[int(m[2])] = name
        elif m := _HEAD.match(name):
            s.heads[m[2]] = name
    s.encoder = [[blk[j] for j in sorted(blk)] for _, blk in sorted(enc.items())]
    s.middle = [mid[k] for k in sorted(mid)]
    s.decoder = [[blk[j] for j in sorted(blk)] for _, blk in sorted(dec.items())]
    if not s.encoder or not s.heads:
        raise ValueError("no UNet encoder or head among the weights")
    return s


def bias_of(weight_name: str) -> str:
    return weight_name[: -len("weight")] + "bias"


Conv = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, int], torch.Tensor]


def plain_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pad: int) -> torch.Tensor:
    return F.conv2d(x, w, b, padding=pad)


def forward(state: Dict[str, torch.Tensor], x: torch.Tensor,
            head_strides: Dict[str, int], conv: Conv = plain_conv,
            st: Optional[Structure] = None) -> Dict[str, torch.Tensor]:
    """Head maps ``{head: (B, H/s, W/s, C)}`` of NHWC input ``x`` (B, H, W, 1).

    ``head_strides``: each head's output stride. ``conv``: the convolution
    (the float32 one, or a control's lower precision).
    """
    st = st or structure(state)
    if x.shape[1] % st.max_stride or x.shape[2] % st.max_stride:
        raise ValueError(f"input {tuple(x.shape)} is not a multiple of stride {st.max_stride}")

    def c(v, name, relu=True):
        w = state[name]
        y = conv(v, w, state[bias_of(name)], w.shape[-1] // 2)
        return torch.relu(y) if relu else y

    v = x.permute(0, 3, 1, 2).float()
    skips = []
    for b, names in enumerate(st.encoder):
        if b > 0:
            v = F.max_pool2d(v, 2, 2)
        for name in names:
            v = c(v, name)
        skips.append(v)
    v = F.max_pool2d(v, 2, 2)
    for name in st.middle:
        v = c(v, name)
    by_stride = {}
    for b, names in enumerate(st.decoder):
        v = F.interpolate(v, size=(v.shape[2] * 2, v.shape[3] * 2), mode="bilinear",
                          align_corners=False)
        v = torch.cat([skips[-1 - b], v], dim=1)
        for name in names:
            v = c(v, name)
        by_stride[st.decoder_strides()[b]] = v
    out = {}
    for head, name in st.heads.items():
        out[head] = c(by_stride[head_strides[head]], name, relu=False).permute(0, 2, 3, 1)
    return out


def conv_shapes(state: Dict[str, torch.Tensor], in_hw: Tuple[int, int],
                head_strides: Dict[str, int]) -> List[Tuple[str, int, int, int, int, int]]:
    """``(name, H_out, W_out, C_in, C_out, k)`` of every conv of one forward on
    an ``in_hw`` input, in the order the forward applies them."""
    st = structure(state)
    h, w = in_hw
    out = []

    def add(name, hh, ww):
        co, ci, k, _ = state[name].shape
        out.append((name, hh, ww, ci, co, k))

    for b, names in enumerate(st.encoder):
        if b > 0:
            h, w = h // 2, w // 2
        for name in names:
            add(name, h, w)
    h, w = h // 2, w // 2
    for name in st.middle:
        add(name, h, w)
    sizes = {}
    for b, names in enumerate(st.decoder):
        h, w = h * 2, w * 2
        for name in names:
            add(name, h, w)
        sizes[st.decoder_strides()[b]] = (h, w)
    for head, name in st.heads.items():
        add(name, *sizes[head_strides[head]])
    return out
