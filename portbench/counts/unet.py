"""Operations of a UNet forward, from the shapes of its weights.

A conv of ``k x k`` from ``C_in`` to ``C_out`` channels on an output of
``H x W`` costs ``2 * H * W * C_in * C_out * k * k`` operations (a
multiply and an add each); pooling, upsampling, bias and activations are
not counted.
"""

from __future__ import annotations

from typing import Dict, Tuple

from portbench.reference.unet import conv_shapes


def conv_flops(h: int, w: int, c_in: int, c_out: int, k: int) -> float:
    return 2.0 * h * w * c_in * c_out * k * k


def forward_flops(state: Dict, in_hw: Tuple[int, int], head_strides: Dict[str, int]) -> float:
    """Operations of one forward of one ``in_hw`` input."""
    return sum(conv_flops(h, w, ci, co, k)
               for _, h, w, ci, co, k in conv_shapes(state, in_hw, head_strides))
