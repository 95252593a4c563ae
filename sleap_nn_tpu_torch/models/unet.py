"""Stride-anchored UNet backbone (torch, NHWC).

Port of ``sleap_nn_tpu/models/unet.py``: same filter schedule
(``filters * filters_rate**level``), stem / middle-block semantics, stacks
and per-stride decoder outputs. State-dict keys carry the reference's
block names: ``encoders.{i}.encoder_stack.{b}.blocks.stack{i}_enc{b}_conv{j}``,
``middle_blocks.{k}.blocks.stack{i}_enc{D}_middle_{expand|contract}_conv0``
and ``decoders.{i}.decoder_stack.{b}.blocks.stack{i}_dec{b}_s{S}_to_s{S/2}_*``.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
from torch import nn

from sleap_nn_tpu_torch.models.encoder_decoder import (
    Decoder,
    Encoder,
    SimpleConvBlock,
    StemBlock,
    decoder_block_filters,
)


class UNet(nn.Module):
    """U-Net: encoder -> (middle) -> decoder with per-stride outputs.

    ``forward`` returns a dict with ``outputs`` (one map per decoder
    stride), ``strides``, ``middle_output`` and ``intermediate_feat``.
    """

    def __init__(
        self,
        in_channels: int = 1,
        filters: int = 32,
        filters_rate: float = 1.5,
        kernel_size: int = 3,
        stem_kernel_size: int = 7,
        down_blocks: int = 4,
        up_blocks: int = 3,
        stem_blocks: int = 0,
        convs_per_block: int = 2,
        middle_block: bool = True,
        up_interpolate: bool = True,
        block_contraction: bool = False,
        stacks: int = 1,
        trans_conv_phase: str = "torch",
    ):
        super().__init__()
        self.in_channels = in_channels
        self.filters = filters
        self.filters_rate = filters_rate
        self.kernel_size = kernel_size
        self.down_blocks = down_blocks
        self.up_blocks = up_blocks
        self.stem_blocks = stem_blocks
        self.convs_per_block = convs_per_block
        self.middle_block = middle_block
        self.up_interpolate = up_interpolate
        self.block_contraction = block_contraction
        self.stacks = stacks

        c = in_channels
        self.stem = None
        if stem_blocks > 0:
            self.stem = StemBlock(c, filters, stem_blocks, filters_rate,
                                  convs_per_block, stem_kernel_size)
            c = self.stem.out_channels
        stem_channels = c
        mid_name = down_blocks + stem_blocks
        self.encoders = nn.ModuleList()
        self.middle_blocks = nn.ModuleList()
        self.decoders = nn.ModuleList()
        for i in range(stacks):
            enc = Encoder(c, filters, down_blocks, filters_rate, convs_per_block,
                          kernel_size, stem_blocks, prefix=f"stack{i}_enc")
            self.encoders.append(enc)
            c = enc.out_channels
            if middle_block:
                if convs_per_block > 1:
                    self.middle_blocks.append(SimpleConvBlock(
                        c, self.middle_channels, num_convs=convs_per_block - 1,
                        kernel_size=kernel_size, pool=False,
                        prefix=f"stack{i}_enc{mid_name}_middle_expand"))
                    c = self.middle_channels
                self.middle_blocks.append(SimpleConvBlock(
                    c, self._decoder_in_channels(), num_convs=1,
                    kernel_size=kernel_size, pool=False,
                    prefix=f"stack{i}_enc{mid_name}_middle_contract"))
                c = self._decoder_in_channels()
            # The decoder's input (``middle_output``, ``intermediate_feat``).
            self.bottleneck_channels = c
            skips = enc.block_channels[::-1] + ([stem_channels] if stem_blocks > 0 else [])
            self.decoders.append(Decoder(
                c, skips, filters, up_blocks, down_blocks, filters_rate,
                self.max_stride, stem_blocks, convs_per_block, kernel_size,
                up_interpolate, block_contraction, trans_conv_phase,
                prefix=f"stack{i}_dec"))
            if up_blocks > 0:
                c = decoder_block_filters(filters, filters_rate, down_blocks,
                                          stem_blocks, block_contraction, up_blocks - 1)
        self._middle_per_stack = len(self.middle_blocks) // stacks

    @property
    def max_stride(self) -> int:
        """Bottleneck stride (with a stem the encoder's first block also pools)."""
        s = 2 ** (self.down_blocks + self.stem_blocks)
        return s * 2 if self.stem_blocks > 0 else s

    @property
    def output_stride(self) -> int:
        return self.max_stride // (2**self.up_blocks)

    @property
    def stride_to_filters(self) -> Dict[int, int]:
        """Decoder output stride -> channels (for head binding)."""
        out = {self.max_stride: self._decoder_in_channels()}
        stride = self.max_stride
        for block in range(self.up_blocks):
            stride //= 2
            out[stride] = decoder_block_filters(
                self.filters, self.filters_rate, self.down_blocks,
                self.stem_blocks, self.block_contraction, block)
        return out

    @property
    def middle_channels(self) -> int:
        return int(self.filters * (self.filters_rate ** (self.down_blocks + self.stem_blocks)))

    def _decoder_in_channels(self) -> int:
        if self.block_contraction:
            return int(
                self.filters * (self.filters_rate ** (self.down_blocks + self.stem_blocks - 1))
            )
        return self.middle_channels

    @classmethod
    def from_config(cls, config) -> "UNet":
        """Build from a UNetConfig-shaped object (max_stride/output_stride anchored)."""
        stem_blocks = 0
        stem_stride = getattr(config, "stem_stride", None)
        if stem_stride:
            stem_blocks = int(math.log2(stem_stride))
        down_blocks = int(math.log2(config.max_stride)) - stem_blocks
        up_blocks = int(math.log2(config.max_stride / config.output_stride)) + stem_blocks
        return cls(
            in_channels=getattr(config, "in_channels", 1),
            filters=config.filters,
            filters_rate=config.filters_rate,
            kernel_size=config.kernel_size,
            down_blocks=down_blocks,
            up_blocks=up_blocks,
            stem_blocks=stem_blocks,
            convs_per_block=config.convs_per_block,
            middle_block=config.middle_block,
            up_interpolate=config.up_interpolate,
            stacks=getattr(config, "stacks", 1),
            trans_conv_phase=getattr(config, "trans_conv_phase", None) or "torch",
        )

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        if self.stem is not None:
            x = self.stem(x)
        stem_output = x
        output = x
        result = None
        n_mid = self._middle_per_stack
        for i in range(self.stacks):
            middle, features = self.encoders[i](output)
            for block in self.middle_blocks[i * n_mid:(i + 1) * n_mid]:
                middle = block(middle)
            if self.stem is not None:
                features = features + [stem_output]
            result = self.decoders[i](middle, features)
            result["middle_output"] = middle
            output = result["outputs"][-1] if result["outputs"] else middle
        return result
