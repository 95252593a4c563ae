"""Swin Transformer encoder + SLEAP decoder backbone (torch, NHWC).

Port of ``sleap_nn_tpu/models/swint.py``: patch embed (k=patch_size,
s=stem_patch_stride, p1) and LayerNorm, four stages of (shifted) window
attention with patch merging, skips at the patch-embed and merge outputs,
an extra 2x pool before the middle blocks and the SLEAP decoder. Modules
are named after the JAX package's flax tree (``enc.stage0_block1.attn.qkv``,
``enc.merge0.reduction``, ...).

Window attention pads the map to whole windows and shifts only when
``min(h, w) > window``; shifted windows mask cross-boundary pairs with
-100. Attention is plain ``matmul`` + ``softmax`` (the JAX package computes
it outside any Pallas kernel). LayerNorm eps 1e-5; the MLP's GELU is
flax's default, the tanh approximation.
"""

from __future__ import annotations

import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sleap_nn_tpu_torch.models.convnext import EncoderDecoderWrapper
from sleap_nn_tpu_torch.models.encoder_decoder import conv_nhwc

ARCHS = {
    "tiny": {"embed": 96, "depths": [2, 2, 6, 2], "num_heads": [3, 6, 12, 24]},
    "small": {"embed": 96, "depths": [2, 2, 18, 2], "num_heads": [3, 6, 12, 24]},
    "base": {"embed": 128, "depths": [2, 2, 18, 2], "num_heads": [4, 8, 16, 32]},
}


def _rel_position_index(wh: int, ww: int) -> np.ndarray:
    """Relative position index table for a (wh, ww) window."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wh - 1
    rel[:, :, 1] += ww - 1
    rel[:, :, 0] *= 2 * ww - 1
    return rel.sum(-1)  # (N, N)


@functools.lru_cache(maxsize=32)
def shifted_window_mask(hp: int, wp: int, ws: int, shift: int) -> np.ndarray:
    """(num_windows, ws*ws, ws*ws) mask: -100 between tokens of different
    regions of the rolled map, else 0 (made once a geometry; read-only)."""
    img_mask = np.zeros((hp, wp))
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wslice in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img_mask[hs, wslice] = cnt
            cnt += 1
    mask = img_mask.reshape(hp // ws, ws, wp // ws, ws).transpose(0, 2, 1, 3).reshape(
        -1, ws * ws)
    return (mask[:, None, :] != mask[:, :, None]) * -100.0


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) with H, W multiples of ``ws`` -> (B*nW, ws*ws, C)."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_merge(x: torch.Tensor, b: int, h: int, w: int, ws: int) -> torch.Tensor:
    """Inverse of ``window_partition``."""
    c = x.shape[-1]
    x = x.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


class WindowAttention(nn.Module):
    """Multi-head self-attention inside (shifted) windows with rel-pos bias."""

    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.shift = shift
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_bias = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        # flax's truncated_normal(0.02): a standard normal cut at +-2, times 0.02.
        nn.init.trunc_normal_(self.rel_pos_bias, std=0.02, a=-0.04, b=0.04)
        self.register_buffer(
            "rel_index", torch.from_numpy(_rel_position_index(window_size, window_size)
                                          .reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, heads = self.window_size, self.num_heads
        shift = self.shift if min(h, w) > ws else 0
        pad_h, pad_w = (ws - h % ws) % ws, (ws - w % ws) % ws
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        if shift:
            x = torch.roll(x, shifts=(-shift, -shift), dims=(1, 2))
        xw = window_partition(x, ws)
        n = ws * ws
        q, k, v = self.qkv(xw).reshape(-1, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
        attn = (q @ k.transpose(-1, -2)) / math.sqrt(c // heads)
        bias = self.rel_pos_bias[self.rel_index].reshape(n, n, heads).permute(2, 0, 1)
        attn = attn + bias[None]
        if shift:
            mask = torch.as_tensor(shifted_window_mask(hp, wp, ws, shift),
                                   dtype=attn.dtype, device=attn.device)
            nw = mask.shape[0]
            attn = (attn.reshape(b, nw, heads, n, n) + mask[None, :, None]).reshape(
                b * nw, heads, n, n)
        out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(-1, n, c)
        out = window_merge(self.proj(out), b, hp, wp, ws)
        if shift:
            out = torch.roll(out, shifts=(shift, shift), dims=(1, 2))
        return out[:, :h, :w, :]


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, shift: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, num_heads, window_size, shift)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp2 = nn.Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp2(F.gelu(self.mlp1(self.norm2(x)), approximate="tanh"))


class PatchMerging(nn.Module):
    """2x2 neighbourhood concat -> LN -> Linear(2C), odd sizes padded."""

    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=1e-5)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.pad(x, (0, 0, 0, x.shape[2] % 2, 0, x.shape[1] % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.reduction(self.norm(x))


class SwinTransformerEncoder(nn.Module):
    """Swin encoder returning the patch-embed, stage and merge outputs."""

    def __init__(self, in_channels: int, embed_dim: int, depths: Tuple[int, ...],
                 num_heads: Tuple[int, ...], patch_size: int = 4, stem_stride: int = 2,
                 window_size: int = 7):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_embed = nn.Conv2d(in_channels, embed_dim, patch_size, stride=stem_stride,
                                     padding=1)
        self.patch_norm = nn.LayerNorm(embed_dim, eps=1e-5)
        for i, depth in enumerate(depths):
            dim = embed_dim * (2**i)
            for b in range(depth):
                self.add_module(f"stage{i}_block{b}", SwinBlock(
                    dim, num_heads[i], window_size,
                    shift=0 if b % 2 == 0 else window_size // 2))
            if i == len(depths) - 1:
                self.final_norm = nn.LayerNorm(dim, eps=1e-5)
            else:
                self.add_module(f"merge{i}", PatchMerging(dim))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.patch_norm(conv_nhwc(self.patch_embed, x))
        feats = [x]
        for i, depth in enumerate(self.depths):
            for b in range(depth):
                x = getattr(self, f"stage{i}_block{b}")(x)
            if i == len(self.depths) - 1:
                x = self.final_norm(x)
            feats.append(x)
            if i < len(self.depths) - 1:
                x = getattr(self, f"merge{i}")(x)
                feats.append(x)
        return feats


class SwinTWrapper(EncoderDecoderWrapper):
    """Swin encoder + SLEAP decoder."""

    def __init__(
        self,
        in_channels: int = 1,
        model_type: str = "tiny",
        arch: Optional[Tuple[int, Tuple[int, ...], Tuple[int, ...]]] = None,
        patch_size: int = 4,
        stem_patch_stride: int = 2,
        window_size: int = 7,
        kernel_size: int = 3,
        filters_rate: float = 2.0,
        convs_per_block: int = 2,
        up_interpolate: bool = True,
        output_stride_cfg: int = 1,
        block_contraction: bool = False,
    ):
        super().__init__()
        a = ({"embed": arch[0], "depths": list(arch[1]), "num_heads": list(arch[2])}
             if arch is not None else ARCHS[model_type])
        self.channels = [a["embed"] * (2**i) for i in range(len(a["depths"]))]
        self.down_blocks = len(a["depths"]) - 1
        self.stem_patch_stride = stem_patch_stride
        self.output_stride_cfg = output_stride_cfg
        self.filters_rate = filters_rate
        self.block_contraction = block_contraction
        self.enc = SwinTransformerEncoder(
            in_channels, a["embed"], tuple(a["depths"]), tuple(a["num_heads"]), patch_size,
            stem_patch_stride, window_size)
        self._build(kernel_size, convs_per_block, up_interpolate)

    @classmethod
    def from_config(cls, config) -> "SwinTWrapper":
        arch = getattr(config, "arch", None)
        if isinstance(arch, dict):
            if len(arch["depths"]) != 4:
                raise ValueError(
                    f"swint arch must have 4 stages, got "
                    f"{len(arch['depths'])} (depths={arch['depths']}).")
            arch = (arch["embed"], tuple(arch["depths"]), tuple(arch["num_heads"]))
        return cls(
            in_channels=getattr(config, "in_channels", 1),
            model_type=getattr(config, "model_type", "tiny"),
            arch=arch,
            patch_size=config.patch_size,
            stem_patch_stride=config.stem_patch_stride,
            window_size=config.window_size,
            kernel_size=config.kernel_size,
            filters_rate=config.filters_rate,
            convs_per_block=config.convs_per_block,
            up_interpolate=config.up_interpolate,
            output_stride_cfg=config.output_stride,
            block_contraction=getattr(config, "block_contraction", False) or False,
        )
