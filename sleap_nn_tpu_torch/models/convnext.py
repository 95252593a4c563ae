"""ConvNeXt encoder + SLEAP decoder backbone (torch, NHWC).

Port of ``sleap_nn_tpu/models/convnext.py``: the stem conv (k4 s2 p1) and
LayerNorm, four stages of ConvNeXt blocks with k2 s2 downsamples, skips at
the stem and downsample outputs (``feats[::2][::-1]``), an extra 2x pool
before the middle blocks and the SLEAP decoder on top. Modules are named
after the JAX package's flax tree (``enc.stage0_block0.dwconv``,
``middle_expand``, ``dec``), so ``weights.flax_to_torch_state`` maps each
leaf by its path.

The block's GELU is flax's default, the tanh approximation.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sleap_nn_tpu_torch.models.encoder_decoder import (
    Decoder,
    SimpleConvBlock,
    conv_nhwc,
    conv_nhwc_same,
    decoder_block_filters,
    max_pool_same,
)

ARCHS = {
    "tiny": {"depths": [3, 3, 9, 3], "channels": [96, 192, 384, 768]},
    "small": {"depths": [3, 3, 27, 3], "channels": [96, 192, 384, 768]},
    "base": {"depths": [3, 3, 27, 3], "channels": [128, 256, 512, 1024]},
    "large": {"depths": [3, 3, 27, 3], "channels": [192, 384, 768, 1536]},
}


class CNBlock(nn.Module):
    """ConvNeXt block: dwconv7 -> LN -> MLP(4x) -> layer scale -> residual."""

    def __init__(self, dim: int, layer_scale: float = 1e-6):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)
        self.gamma = nn.Parameter(torch.full((dim,), layer_scale))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.norm(conv_nhwc(self.dwconv, x))
        y = self.pwconv2(F.gelu(self.pwconv1(y), approximate="tanh"))
        return x + y * self.gamma


class ConvNeXtEncoder(nn.Module):
    """Four-stage ConvNeXt returning every stem, stage and downsample output."""

    def __init__(self, in_channels: int, depths: Tuple[int, ...], channels: Tuple[int, ...],
                 stem_kernel: int = 4, stem_stride: int = 2):
        super().__init__()
        self.depths = tuple(depths)
        self.stem_conv = nn.Conv2d(in_channels, channels[0], stem_kernel, stride=stem_stride,
                                   padding=1)
        self.stem_norm = nn.LayerNorm(channels[0], eps=1e-6)
        for i, (depth, dim) in enumerate(zip(depths, channels)):
            for b in range(depth):
                self.add_module(f"stage{i}_block{b}", CNBlock(dim))
            if i < len(depths) - 1:
                self.add_module(f"down{i}_norm", nn.LayerNorm(dim, eps=1e-6))
                self.add_module(f"down{i}_conv", nn.Conv2d(dim, channels[i + 1], 2, stride=2))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.stem_norm(conv_nhwc(self.stem_conv, x))
        feats = [x]
        for i, depth in enumerate(self.depths):
            for b in range(depth):
                x = getattr(self, f"stage{i}_block{b}")(x)
            feats.append(x)
            if i < len(self.depths) - 1:
                x = conv_nhwc_same(getattr(self, f"down{i}_conv"),
                                   getattr(self, f"down{i}_norm")(x))
                feats.append(x)
        return feats


class EncoderDecoderWrapper(nn.Module):
    """Shared forward and geometry of the ConvNeXt and SwinT wrappers: an
    encoder whose ``feats[::2][::-1]`` are the skips, a 2x pool, the middle
    blocks and the SLEAP decoder. Subclasses set ``enc``, ``channels``,
    ``stem_patch_stride``, ``output_stride_cfg``, ``filters_rate`` and
    ``block_contraction``, then call ``_build``."""

    down_blocks = 3
    stem_blocks = 1

    def _build(self, kernel_size: int, convs_per_block: int, up_interpolate: bool) -> None:
        self.middle_expand = None
        c = self.channels[-1]
        if convs_per_block > 1:
            self.middle_expand = SimpleConvBlock(
                c, self.middle_channels, num_convs=convs_per_block - 1,
                kernel_size=kernel_size, pool=False, prefix="middle_expand")
            c = self.middle_channels
        self.middle_contract = SimpleConvBlock(
            c, self.bottleneck_channels, num_convs=1, kernel_size=kernel_size, pool=False,
            prefix="middle_contract")
        skips = self.channels[::-1]  # [down2, down1, down0, stem] outputs
        self.dec = Decoder(
            self.bottleneck_channels, skips, self.channels[0], self.up_blocks,
            self.down_blocks, self.filters_rate, self.max_stride, self.stem_blocks,
            convs_per_block, kernel_size, up_interpolate, self.block_contraction,
            prefix="dec")

    @property
    def max_stride(self) -> int:
        # stem stride * 2^3 stage downsamples * the final 2x pool.
        return self.stem_patch_stride * (2**3) * 2

    @property
    def up_blocks(self) -> int:
        return int(
            math.log2(self.max_stride / (self.stem_patch_stride * self.output_stride_cfg))
        ) + int(math.log2(self.stem_patch_stride))

    @property
    def middle_channels(self) -> int:
        return int(self.channels[-1] * self.filters_rate)

    @property
    def bottleneck_channels(self) -> int:
        """Channels of the decoder's input (``intermediate_feat``)."""
        c = self.channels[-1]
        return int(c) if self.block_contraction else int(c * self.filters_rate)

    @property
    def stride_to_filters(self) -> Dict[int, int]:
        out = {self.max_stride: self.bottleneck_channels}
        stride = self.max_stride
        for block in range(self.up_blocks):
            stride //= 2
            out[stride] = decoder_block_filters(
                self.channels[0], self.filters_rate, self.down_blocks, self.stem_blocks,
                self.block_contraction, block)
        return out

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        feats = self.enc(x)
        skips = feats[::2][::-1]
        middle = max_pool_same(feats[-1])
        if self.middle_expand is not None:
            middle = self.middle_expand(middle)
        middle = self.middle_contract(middle)
        result = self.dec(middle, skips)
        result["middle_output"] = middle
        return result


class ConvNextWrapper(EncoderDecoderWrapper):
    """ConvNeXt encoder + SLEAP decoder."""

    def __init__(
        self,
        in_channels: int = 1,
        model_type: str = "tiny",
        arch: Optional[Tuple[Tuple[int, ...], Tuple[int, ...]]] = None,
        stem_patch_kernel: int = 4,
        stem_patch_stride: int = 2,
        kernel_size: int = 3,
        filters_rate: float = 2.0,
        convs_per_block: int = 2,
        up_interpolate: bool = True,
        output_stride_cfg: int = 1,
        block_contraction: bool = False,
    ):
        super().__init__()
        a = ({"depths": list(arch[0]), "channels": list(arch[1])} if arch is not None
             else ARCHS[model_type])
        self.channels = [int(c) for c in a["channels"]]
        self.stem_patch_stride = stem_patch_stride
        self.output_stride_cfg = output_stride_cfg
        self.filters_rate = filters_rate
        self.block_contraction = block_contraction
        self.enc = ConvNeXtEncoder(in_channels, tuple(a["depths"]), tuple(self.channels),
                                   stem_patch_kernel, stem_patch_stride)
        self._build(kernel_size, convs_per_block, up_interpolate)

    @classmethod
    def from_config(cls, config) -> "ConvNextWrapper":
        arch = getattr(config, "arch", None)
        if isinstance(arch, dict):
            if len(arch["depths"]) != 4:
                raise ValueError(
                    f"convnext arch must have 4 stages, got "
                    f"{len(arch['depths'])} (depths={arch['depths']}).")
            arch = (tuple(arch["depths"]), tuple(arch["channels"]))
        return cls(
            in_channels=getattr(config, "in_channels", 1),
            model_type=getattr(config, "model_type", "tiny"),
            arch=arch,
            stem_patch_kernel=config.stem_patch_kernel,
            stem_patch_stride=config.stem_patch_stride,
            kernel_size=config.kernel_size,
            filters_rate=config.filters_rate,
            convs_per_block=config.convs_per_block,
            up_interpolate=config.up_interpolate,
            output_stride_cfg=config.output_stride,
            block_contraction=getattr(config, "block_contraction", False) or False,
        )
