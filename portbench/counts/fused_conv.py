"""Operations and bytes of one call of the fused double 3x3 conv kernel
(``ops/fused_conv.py`` -> ``csrc/fused_double_conv3x3.cu``).

A call computes ``act(conv3x3(act(conv3x3(x) + b1)) + b2)`` on NHWC ``x``
of ``(B, H, W, C_in)``, through ``C_mid`` to ``C_out`` channels. It needs
``2 * B * H * W * 9 * (C_in * C_mid + C_mid * C_out)`` operations and
reads ``x`` and the weights once and writes the output once: ``(B * H * W
* (C_in + C_out) + 9 * (C_in * C_mid + C_mid * C_out)) * itemsize`` bytes
plus the float32 biases. The intermediate stays on chip and is not
counted. As the repository's chip smoke counts them.
"""

from __future__ import annotations

from typing import Tuple

from portbench.counts.peaks import PEAK_BF16, PEAK_F32, bound


def call_cost(b: int, h: int, w: int, c_in: int, c_mid: int, c_out: int,
              itemsize: int) -> Tuple[float, float]:
    """(operations, bytes) of one call."""
    flops = 2.0 * b * h * w * 9 * (c_in * c_mid + c_mid * c_out)
    nbytes = (b * h * w * (c_in + c_out) + 9 * (c_in * c_mid + c_mid * c_out)) * itemsize \
        + 4 * (c_mid + c_out)
    return flops, nbytes


def call_bound_s(b: int, h: int, w: int, c_in: int, c_mid: int, c_out: int,
                 itemsize: int) -> float:
    """The least seconds one call can take on the card."""
    flops, nbytes = call_cost(b, h, w, c_in, c_mid, c_out, itemsize)
    return bound(flops, nbytes, PEAK_BF16 if itemsize == 2 else PEAK_F32)[0]


def span_name(b: int, h: int, w: int, c_in: int, c_mid: int, c_out: int, itemsize: int) -> str:
    """The benchmark span around one call: its shape, read back by :func:`parse_span`."""
    return f"portbench.fused_conv {b} {h} {w} {c_in} {c_mid} {c_out} {itemsize}"


def parse_span(name: str):
    """The ``(b, h, w, c_in, c_mid, c_out, itemsize)`` of a :func:`span_name`."""
    head, *nums = name.split(" ")
    if head != "portbench.fused_conv" or len(nums) != 7:
        return None
    return tuple(int(n) for n in nums)
