"""Generic encoder-decoder conv blocks (torch, NHWC at every block boundary).

Port of ``sleap_nn_tpu/models/encoder_decoder.py``: same filter and stride
schedules, skip topology and fused-block eligibility. Tensors stay
channel-last between blocks; a torch conv sees them through a permuted
(channels-last strided) NCHW view. Each block's ``blocks`` dict names its
convs with the reference's block names (``stack0_enc0_conv0``,
``stack0_dec0_s32_to_s16_refine_conv1``, ...), so ``state_dict()`` keys
carry them.

The JAX package's space-to-depth ("packed") blocks are a TPU layout
rewrite of the same function and are not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sleap_nn_tpu_torch.data.resizing import resize_bilinear
from sleap_nn_tpu_torch.ops.fused_conv import fused_double_conv3x3

_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "identity": lambda x: x,
    None: lambda x: x,
    "": lambda x: x,
}


def get_act_fn(name: Optional[str]):
    """Activation registry (channel-last: softmax runs over the last axis)."""
    if name not in _ACTS:
        raise KeyError(f"Unsupported activation: {name}")
    return _ACTS[name]


def conv_nhwc(conv: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """Apply an NCHW torch conv module to an NHWC tensor."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def hwio(weight: torch.Tensor) -> torch.Tensor:
    """OIHW conv weight -> HWIO view (the JAX package's kernel layout)."""
    return weight.permute(2, 3, 1, 0)


def max_pool_same(x: torch.Tensor, stride: int = 2) -> torch.Tensor:
    """2x2 max pool, SAME padding (lax.reduce_window pads -inf, low side first)."""
    pads = []
    for n in (x.shape[2], x.shape[1]):  # F.pad order: W, then H
        total = max((-(-n // stride) - 1) * stride + 2 - n, 0)
        pads += [total // 2, total - total // 2]
    y = x.permute(0, 3, 1, 2)
    if any(pads):
        y = F.pad(y, pads, value=float("-inf"))
    return F.max_pool2d(y, 2, stride).permute(0, 2, 3, 1)


def bilinear_upsample(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """Bilinear upsample with half-pixel centers (``jax.image.resize``)."""
    return resize_bilinear(x, x.shape[1] * factor, x.shape[2] * factor)


class SimpleConvBlock(nn.Module):
    """Conv block: [pool] -> num_convs x (conv + act) -> [pool].

    ``use_fused``: evaluate the two convs as ONE kernel
    (``ops/fused_conv.py``) with the inter-conv activation kept on chip;
    same weights, forward only.
    """

    def __init__(
        self,
        in_channels: int,
        filters: int,
        num_convs: int = 2,
        kernel_size: int = 3,
        pool: bool = True,
        pool_before_convs: bool = False,
        pooling_stride: int = 2,
        activation: str = "relu",
        use_bias: bool = True,
        prefix: str = "block",
        use_fused: bool = False,
    ):
        super().__init__()
        self.num_convs = num_convs
        self.kernel_size = kernel_size
        self.pool = pool
        self.pool_before_convs = pool_before_convs
        self.pooling_stride = pooling_stride
        self.activation = activation
        self.use_fused = use_fused
        self.blocks = nn.ModuleDict()
        c = in_channels
        for i in range(num_convs):
            self.blocks[f"{prefix}_conv{i}"] = nn.Conv2d(
                c, filters, kernel_size, padding="same", bias=use_bias)
            c = filters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pool and self.pool_before_convs:
            x = max_pool_same(x, self.pooling_stride)
        convs = list(self.blocks.values())
        if (
            self.use_fused
            and self.num_convs == 2
            and self.kernel_size == 3
            and self.activation in ("relu", "identity")
        ):
            x = fused_double_conv3x3(
                x.contiguous(), hwio(convs[0].weight), convs[0].bias,
                hwio(convs[1].weight), convs[1].bias,
                activation=self.activation)
        else:
            act = get_act_fn(self.activation)
            for conv in convs:
                x = act(conv_nhwc(conv, x))
        if self.pool and not self.pool_before_convs:
            x = max_pool_same(x, self.pooling_stride)
        return x


class StemBlock(nn.Module):
    """Initial downsampling stack run before the encoder.

    ``stem_blocks`` conv blocks (block 0 unpooled, later blocks
    pool-before-convs) followed by a final 2x pool.
    """

    def __init__(self, in_channels: int, filters: int, stem_blocks: int,
                 filters_rate: float, convs_per_block: int = 2,
                 kernel_size: int = 7):
        super().__init__()
        self.stem_stack = nn.ModuleList()
        c = in_channels
        for block in range(stem_blocks):
            f = int(filters * (filters_rate**block))
            self.stem_stack.append(SimpleConvBlock(
                c, f, num_convs=convs_per_block, kernel_size=kernel_size,
                pool=block > 0, pool_before_convs=True, prefix=f"stem{block}"))
            c = f
        self.out_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.stem_stack:
            x = block(x)
        return max_pool_same(x)


class Encoder(nn.Module):
    """Downsampling feature stack; returns bottleneck + skip features.

    Skip features are the outputs of each conv block (pre-final-pool),
    returned deepest-first to pair with the decoder's up blocks.
    """

    def __init__(
        self,
        in_channels: int,
        filters: int,
        down_blocks: int,
        filters_rate: float,
        convs_per_block: int = 2,
        kernel_size: int = 3,
        stem_blocks: int = 0,
        prefix: str = "stack0_enc",
        use_fused: bool = False,
    ):
        super().__init__()
        self.encoder_stack = nn.ModuleList()
        self.block_channels: List[int] = []
        c = in_channels
        for block in range(down_blocks):
            f = int(filters * (filters_rate ** (block + stem_blocks)))
            self.encoder_stack.append(SimpleConvBlock(
                c, f, num_convs=convs_per_block, kernel_size=kernel_size,
                pool=(block + stem_blocks) > 0, pool_before_convs=True,
                prefix=f"{prefix}{block}", use_fused=use_fused))
            self.block_channels.append(f)
            c = f
        self.out_channels = c

    def forward(self, x: torch.Tensor):
        features = []
        for block in self.encoder_stack:
            x = block(x)
            features.append(x)
        return max_pool_same(x), features[::-1]


class SimpleUpsamplingBlock(nn.Module):
    """Upsample (bilinear or transposed conv) -> concat skip -> refine convs.

    ``skip_channels=0`` builds the block without a skip concat.

    Transposed conv, "torch" phase: ``ConvTranspose2d(k=3, s=2, padding=1,
    output_padding=1)``, the reference layer the JAX package reproduces
    with explicit ((1, 2), (1, 2)) padding and a flipped kernel. "tf" phase
    (flax SAME, pads (2, 1) on the dilated input): ``padding=0`` and the
    last row / column dropped.
    """

    def __init__(
        self,
        in_channels: int,
        skip_channels: int,
        refine_convs_filters: int,
        refine_convs: int = 2,
        kernel_size: int = 3,
        up_interpolate: bool = True,
        transpose_convs_filters: Optional[int] = None,
        trans_conv_phase: str = "torch",
        prefix: str = "dec",
        use_fused: bool = False,
    ):
        super().__init__()
        self.refine_convs = refine_convs
        self.kernel_size = kernel_size
        self.up_interpolate = up_interpolate
        self.use_fused = use_fused
        self.has_skip = skip_channels > 0
        self.blocks = nn.ModuleDict()
        c = in_channels
        if not up_interpolate:
            if kernel_size != 3:
                raise NotImplementedError("transposed-conv upsampling is ported for kernel_size=3")
            torch_phase = trans_conv_phase == "torch"
            t = transpose_convs_filters or refine_convs_filters
            self.blocks[f"{prefix}_trans_conv"] = nn.ConvTranspose2d(
                c, t, kernel_size, stride=2,
                padding=1 if torch_phase else 0,
                output_padding=1 if torch_phase else 0)
            c = t
        c += skip_channels
        for i in range(refine_convs):
            self.blocks[f"{prefix}_refine_conv{i}"] = nn.Conv2d(
                c, refine_convs_filters, kernel_size, padding="same")
            c = refine_convs_filters

    def forward(self, x: torch.Tensor, feature: Optional[torch.Tensor]) -> torch.Tensor:
        convs = list(self.blocks.values())
        if self.up_interpolate:
            x = bilinear_upsample(x)
        else:
            h, w = x.shape[1], x.shape[2]
            x = conv_nhwc(convs.pop(0), x)[:, : 2 * h, : 2 * w]
            x = torch.relu(x)
        if self.has_skip:
            if x.shape[1:3] != feature.shape[1:3]:
                x = resize_bilinear(x, feature.shape[1], feature.shape[2])
            x = torch.cat([feature, x], dim=-1)
        if self.use_fused and self.refine_convs == 2 and self.kernel_size == 3:
            return fused_double_conv3x3(
                x.contiguous(), hwio(convs[0].weight), convs[0].bias,
                hwio(convs[1].weight), convs[1].bias, activation="relu")
        for conv in convs:
            x = torch.relu(conv_nhwc(conv, x))
        return x


def decoder_block_filters(
    filters: int,
    filters_rate: float,
    down_blocks: int,
    stem_blocks: int,
    block_contraction: bool,
    block: int,
) -> int:
    """Decoder refine-conv filter schedule (reference: Decoder.__init__)."""
    if block_contraction:
        return int(filters * (filters_rate ** (down_blocks + stem_blocks - 2 - block)))
    return int(filters * (filters_rate ** max(0, down_blocks + stem_blocks - 1 - block)))


class Decoder(nn.Module):
    """Upsampling stack emitting one feature map per stride level.

    ``skip_channels``: channels of the encoder features, deepest first.
    """

    def __init__(
        self,
        in_channels: int,
        skip_channels: Sequence[int],
        filters: int,
        up_blocks: int,
        down_blocks: int,
        filters_rate: float,
        current_stride: int,
        stem_blocks: int = 0,
        convs_per_block: int = 2,
        kernel_size: int = 3,
        up_interpolate: bool = True,
        block_contraction: bool = False,
        trans_conv_phase: str = "torch",
        prefix: str = "stack0_dec",
        use_fused: bool = False,
    ):
        super().__init__()
        self.current_stride = current_stride
        self.up_blocks = up_blocks
        self.decoder_stack = nn.ModuleList()
        stride, c = current_stride, in_channels
        for block in range(up_blocks):
            no_skip = stem_blocks > 0 and block >= down_blocks + stem_blocks
            skip = skip_channels[block] if (block < len(skip_channels) and not no_skip) else 0
            f = decoder_block_filters(filters, filters_rate, down_blocks,
                                      stem_blocks, block_contraction, block)
            self.decoder_stack.append(SimpleUpsamplingBlock(
                c, skip, f,
                refine_convs=1 if no_skip else convs_per_block,
                kernel_size=kernel_size,
                up_interpolate=up_interpolate,
                transpose_convs_filters=f,
                trans_conv_phase=trans_conv_phase,
                prefix=f"{prefix}{block}_s{stride}_to_s{stride // 2}",
                use_fused=use_fused,
            ))
            stride //= 2
            c = f

    @property
    def strides(self) -> List[int]:
        s, out = self.current_stride, []
        for _ in range(self.up_blocks):
            s //= 2
            out.append(s)
        return out

    def forward(self, x: torch.Tensor, features: Sequence[torch.Tensor]) -> dict:
        outputs = {"intermediate_feat": x, "outputs": [], "strides": self.strides}
        for block, up in enumerate(self.decoder_stack):
            x = up(x, features[block] if up.has_skip else None)
            outputs["outputs"].append(x)
        return outputs
