"""Transformer encoders of the pretrained backbone: Swinv2 (hierarchical)
and ViT / DINOv2 (isotropic), HF-weight-compatible, torch NHWC.

Port of ``sleap_nn_tpu/models/transformer_encoders.py``:

- Swinv2: scaled-cosine window attention with a per-head ``logit_scale``
  clamped at ``log(1/0.01)``, the continuous log-spaced relative position
  bias from a 2-layer MLP, res-post-norm blocks, shifted windows whose mask
  is added twice (as HF does; the values are 0 / -100), end-of-stage patch
  merging and before-downsample feature taps. The window and shift come
  from the config's static resolution, not the runtime one.
- ViT / DINOv2: CLS (and register) tokens, pre-norm blocks (DINOv2 adds
  LayerScale), a final LayerNorm, tokens stripped and reshaped to an NHWC
  map. The position grid is resized with torch's bicubic
  (``align_corners=False``, a = -0.75, borders clamped): the function
  HF's ``interpolate_pos_encoding`` calls and the JAX package rebuilds as
  a matrix.

Attention is plain ``matmul`` + ``softmax``; GELU is the exact form.
Modules are named after the JAX package's flax tree.
"""

from __future__ import annotations

import functools
import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sleap_nn_tpu_torch.models.encoder_decoder import conv_nhwc
from sleap_nn_tpu_torch.models.swint import window_merge, window_partition


# ── Swinv2 ────────────────────────────────────────────────────────────────────


def _swin_relative_coords_table(window: int, pretrained_window: int) -> np.ndarray:
    """Log-spaced continuous relative coords, (1, 2W-1, 2W-1, 2) float32."""
    rh = np.arange(-(window - 1), window, dtype=np.float32)
    rw = np.arange(-(window - 1), window, dtype=np.float32)
    table = np.stack(np.meshgrid(rh, rw, indexing="ij"), axis=-1)[None]
    denom = (pretrained_window - 1) if pretrained_window > 0 else (window - 1)
    if denom > 0:
        table = table / denom
    table *= 8.0
    table = np.sign(table) * np.log2(np.abs(table) + 1.0) / math.log2(8)
    return table.astype(np.float32)


def _swin_relative_position_index(window: int) -> np.ndarray:
    """(W², W²) indices into the flattened (2W-1)² bias table."""
    coords = np.stack(
        np.meshgrid(np.arange(window), np.arange(window), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += window - 1
    rel[:, :, 1] += window - 1
    rel[:, :, 0] *= 2 * window - 1
    return rel.sum(-1)


@functools.lru_cache(maxsize=32)
def _swin_attn_mask(h_pad: int, w_pad: int, window: int, shift: int) -> Optional[np.ndarray]:
    """(num_windows, W², W²) additive mask with 0 / -100 entries (made once
    a geometry; read-only)."""
    if shift <= 0:
        return None
    img = np.zeros((h_pad, w_pad), np.float32)
    slices = (slice(0, -window), slice(-window, -shift), slice(-shift, None))
    count = 0
    for hs in slices:
        for ws in slices:
            img[hs, ws] = count
            count += 1
    win = img.reshape(h_pad // window, window, w_pad // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    mask = win[:, None, :] - win[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def _unit(t: torch.Tensor) -> torch.Tensor:
    """Rows scaled to unit L2 norm (torch ``F.normalize``'s eps 1e-12)."""
    return t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)


class Swinv2WindowAttention(nn.Module):
    """Scaled-cosine window attention with continuous relative bias."""

    def __init__(self, dim: int, num_heads: int, window: int, qkv_bias: bool = True,
                 pretrained_window: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim, bias=qkv_bias)
        self.key = nn.Linear(dim, dim, bias=False)
        self.value = nn.Linear(dim, dim, bias=qkv_bias)
        self.logit_scale = nn.Parameter(torch.full((num_heads, 1, 1), math.log(10.0)))
        self.cpb_fc1 = nn.Linear(2, 512)
        self.cpb_fc2 = nn.Linear(512, num_heads, bias=False)
        self.proj = nn.Linear(dim, dim)
        self.register_buffer("coords_table", torch.from_numpy(
            _swin_relative_coords_table(window, pretrained_window)), persistent=False)
        self.register_buffer("rel_index", torch.from_numpy(
            _swin_relative_position_index(window).reshape(-1)), persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        bnw, n, c = x.shape
        h = self.num_heads

        def heads(t):
            return t.reshape(bnw, n, h, c // h).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        attn = _unit(q) @ _unit(k).transpose(-1, -2)
        attn = attn * torch.exp(torch.clamp(self.logit_scale, max=math.log(1.0 / 0.01)))
        cpb = self.cpb_fc2(torch.relu(self.cpb_fc1(self.coords_table.to(x.dtype))))
        bias = cpb.reshape(-1, h)[self.rel_index].reshape(n, n, h).permute(2, 0, 1)
        attn = attn + 16.0 * torch.sigmoid(bias)[None]
        if mask is not None:
            nw = mask.shape[0]
            # HF adds the mask twice; kept for parity (0 / -100 values).
            attn = (attn.reshape(bnw // nw, nw, h, n, n) + 2.0 * mask[None, :, None]).reshape(
                bnw, h, n, n)
        out = (torch.softmax(attn, dim=-1) @ v).transpose(1, 2).reshape(bnw, n, c)
        return self.proj(out)


class Swinv2Block(nn.Module):
    """Res-post-norm Swinv2 block (HF ``Swinv2Layer``)."""

    def __init__(self, dim: int, num_heads: int, input_resolution: Tuple[int, int],
                 target_window: int, shift: int, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, eps: float = 1e-5, pretrained_window: int = 0):
        super().__init__()
        # Window capped by the config's static resolution (as HF's
        # _compute_window_shift, at init time).
        self.window = min(target_window, *input_resolution)
        self.shift = 0 if min(input_resolution) <= self.window else shift
        self.attn = Swinv2WindowAttention(dim, num_heads, self.window, qkv_bias,
                                          pretrained_window)
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.mlp_fc1 = nn.Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = nn.Linear(int(dim * mlp_ratio), dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        h, w = hw
        b, _, c = x.shape
        window, shift = self.window, self.shift
        shortcut = x
        x = x.reshape(b, h, w, c)
        pad_h, pad_w = (-h) % window, (-w) % window
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
        hp, wp = h + pad_h, w + pad_w
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
        mask = _swin_attn_mask(hp, wp, window, shift)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=x.dtype, device=x.device)
        x = window_merge(self.attn(window_partition(x, window), mask), b, hp, wp, window)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        x = x[:, :h, :w].reshape(b, h * w, c)
        x = shortcut + self.norm1(x)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(x)))
        return x + self.norm2(y)


class Swinv2PatchMerging(nn.Module):
    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=eps)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        h, w = hw
        b, _, c = x.shape
        x = F.pad(x.reshape(b, h, w, c), (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        return self.norm(self.reduction(x.reshape(b, -1, 4 * c)))


class Swinv2Encoder(nn.Module):
    """HF-compatible Swinv2 backbone returning the 4-stage pyramid: the
    before-downsample map of each stage, with no extra norm."""

    def __init__(self, in_channels: int = 3, embed_dim: int = 96,
                 depths: Sequence[int] = (2, 2, 6, 2), num_heads: Sequence[int] = (3, 6, 12, 24),
                 window_size: int = 7, patch_size: int = 4, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, layer_norm_eps: float = 1e-5, image_size: int = 224,
                 pretrained_window_sizes: Sequence[int] = (0, 0, 0, 0)):
        super().__init__()
        self.depths = tuple(depths)
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.patch_embed = nn.Conv2d(in_channels, embed_dim, patch_size, stride=patch_size)
        self.embed_norm = nn.LayerNorm(embed_dim, eps=layer_norm_eps)
        grid = image_size // patch_size
        dim = embed_dim
        for s, depth in enumerate(depths):
            res = (max(grid // (2 ** s), 1),) * 2  # static config resolution
            for i in range(depth):
                self.add_module(f"stage{s}_block{i}", Swinv2Block(
                    dim, num_heads[s], res, window_size,
                    shift=0 if i % 2 == 0 else window_size // 2, mlp_ratio=mlp_ratio,
                    qkv_bias=qkv_bias, eps=layer_norm_eps,
                    pretrained_window=pretrained_window_sizes[s]
                    if s < len(pretrained_window_sizes) else 0))
            if s < len(depths) - 1:
                self.add_module(f"stage{s}_downsample",
                                Swinv2PatchMerging(dim, eps=layer_norm_eps))
                dim *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        b = x.shape[0]
        p = self.patch_size
        x = F.pad(x, (0, 0, 0, (-x.shape[2]) % p, 0, (-x.shape[1]) % p))
        x = conv_nhwc(self.patch_embed, x)
        h, w = x.shape[1], x.shape[2]
        x = self.embed_norm(x.reshape(b, h * w, self.embed_dim))
        feats = []
        dim = self.embed_dim
        for s, depth in enumerate(self.depths):
            for i in range(depth):
                x = getattr(self, f"stage{s}_block{i}")(x, (h, w))
            feats.append(x.reshape(b, h, w, dim))
            if s < len(self.depths) - 1:
                x = getattr(self, f"stage{s}_downsample")(x, (h, w))
                h, w = (h + 1) // 2, (w + 1) // 2
                dim *= 2
        return feats


# ── ViT / DINOv2 (isotropic) ──────────────────────────────────────────────────


def resize_pos_grid(grid: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """(n, n, C) position grid -> (gh, gw, C) with torch's bicubic
    (``align_corners=False``), computed in float32."""
    y = F.interpolate(grid.float().permute(2, 0, 1)[None], size=(gh, gw), mode="bicubic",
                      align_corners=False)
    return y[0].permute(1, 2, 0).to(grid.dtype)


class ViTSelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(dim, dim, bias=qkv_bias)
        self.key = nn.Linear(dim, dim, bias=qkv_bias)
        self.value = nn.Linear(dim, dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads

        def heads(t):
            return t.reshape(b, n, h, c // h).transpose(1, 2)

        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        attn = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(c // h), dim=-1)
        return self.proj((attn @ v).transpose(1, 2).reshape(b, n, c))


class ViTBlock(nn.Module):
    """Pre-norm transformer block; DINOv2 adds LayerScale."""

    def __init__(self, dim: int, num_heads: int, intermediate: int,
                 use_layerscale: bool = False, use_swiglu: bool = False,
                 qkv_bias: bool = True, eps: float = 1e-6):
        super().__init__()
        self.use_swiglu = use_swiglu
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = ViTSelfAttention(dim, num_heads, qkv_bias)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.ls1 = self.ls2 = None
        if use_layerscale:
            self.ls1 = nn.Parameter(torch.ones(dim))
            self.ls2 = nn.Parameter(torch.ones(dim))
        if use_swiglu:
            # DINOv2-giant SwiGLU FFN (weights_in emits both halves).
            hidden = (int(dim * 4) * 2 // 3 + 7) // 8 * 8
            self.swiglu_in = nn.Linear(dim, 2 * hidden)
            self.swiglu_out = nn.Linear(hidden, dim)
        else:
            self.mlp_fc1 = nn.Linear(dim, intermediate)
            self.mlp_fc2 = nn.Linear(intermediate, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.attn(self.norm1(x))
        if self.ls1 is not None:
            y = y * self.ls1
        x = x + y
        y = self.norm2(x)
        if self.use_swiglu:
            x1, x2 = self.swiglu_in(y).chunk(2, dim=-1)
            y = self.swiglu_out(F.silu(x1) * x2)
        else:
            y = self.mlp_fc2(F.gelu(self.mlp_fc1(y)))
        if self.ls2 is not None:
            y = y * self.ls2
        return x + y


class ViTEncoder(nn.Module):
    """Isotropic ViT / DINOv2 encoder returning ONE ``(B, H/p, W/p, C)``
    map: CLS and register tokens stripped, the final LayerNorm applied."""

    def __init__(self, in_channels: int = 3, hidden_size: int = 384, num_layers: int = 12,
                 num_heads: int = 6, intermediate_size: int = 1536, patch_size: int = 14,
                 image_size: int = 518, num_register_tokens: int = 0,
                 use_layerscale: bool = True, use_swiglu: bool = False,
                 qkv_bias: bool = True, layer_norm_eps: float = 1e-6):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.n_grid = image_size // patch_size
        self.patch_embed = nn.Conv2d(in_channels, hidden_size, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.randn(1, 1, hidden_size))
        self.position_embeddings = nn.Parameter(
            torch.randn(1, self.n_grid * self.n_grid + 1, hidden_size))
        self.register_tokens = None
        if num_register_tokens:
            self.register_tokens = nn.Parameter(torch.randn(1, num_register_tokens, hidden_size))
        for i in range(num_layers):
            self.add_module(f"block{i}", ViTBlock(
                hidden_size, num_heads, intermediate_size, use_layerscale, use_swiglu,
                qkv_bias, layer_norm_eps))
        self.final_norm = nn.LayerNorm(hidden_size, eps=layer_norm_eps)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        b = x.shape[0]
        c = self.hidden_size
        x = conv_nhwc(self.patch_embed, x)
        gh, gw = x.shape[1], x.shape[2]
        tokens = x.reshape(b, gh * gw, c)
        pos = self.position_embeddings
        pos_cls, pos_patch = pos[:, :1], pos[:, 1:]
        n = self.n_grid
        if (gh, gw) != (n, n):
            pos_patch = resize_pos_grid(pos_patch.reshape(n, n, c), gh, gw).reshape(1, gh * gw, c)
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)
        tokens = tokens + torch.cat([pos_cls, pos_patch], dim=1)
        n_special = 1
        if self.register_tokens is not None:
            tokens = torch.cat([tokens[:, :1], self.register_tokens.expand(b, -1, -1),
                                tokens[:, 1:]], dim=1)
            n_special += self.register_tokens.shape[1]
        for i in range(self.num_layers):
            tokens = getattr(self, f"block{i}")(tokens)
        tokens = self.final_norm(tokens)
        return [tokens[:, n_special:].reshape(b, gh, gw, c)]


# ── HF weight-key mappers ─────────────────────────────────────────────────────
# Each returns (flax path under the encoder, transform) as
# pretrained._map_*_key does, "skip" for buffers, or None for unknown keys.


def map_swinv2_key(key: str):
    if key.startswith("embeddings.patch_embeddings.projection."):
        leaf = key.rsplit(".", 1)[1]
        return ("patch_embed", "kernel" if leaf == "weight" else "bias"), (
            "conv" if leaf == "weight" else "none")
    if key.startswith("embeddings.norm."):
        leaf = key.rsplit(".", 1)[1]
        return ("embed_norm", "scale" if leaf == "weight" else "bias"), "none"
    if key.startswith("embeddings.mask_token") or key.startswith(
            "embeddings.position_embeddings"):
        return "skip"
    m = re.match(r"encoder\.layers\.(\d+)\.downsample\.(reduction|norm)\.(weight|bias)$", key)
    if m:
        s, mod, leaf = int(m[1]), m[2], m[3]
        base = (f"stage{s}_downsample",)
        if mod == "reduction":
            return base + ("reduction", "kernel"), "dense"
        return base + ("norm", "scale" if leaf == "weight" else "bias"), "none"
    m = re.match(r"encoder\.layers\.(\d+)\.blocks\.(\d+)\.(.+)$", key)
    if not m:
        return None
    s, b, rest = int(m[1]), int(m[2]), m[3]
    base = (f"stage{s}_block{b}",)
    leaf = rest.rsplit(".", 1)[1]
    if rest.startswith("attention.self.query."):
        return base + ("attn", "query", "kernel" if leaf == "weight" else "bias"), (
            "dense" if leaf == "weight" else "none")
    if rest.startswith("attention.self.key."):
        return base + ("attn", "key", "kernel"), "dense"
    if rest.startswith("attention.self.value."):
        return base + ("attn", "value", "kernel" if leaf == "weight" else "bias"), (
            "dense" if leaf == "weight" else "none")
    if rest == "attention.self.logit_scale":
        return base + ("attn", "logit_scale"), "none"
    if rest.startswith("attention.self.continuous_position_bias_mlp.0."):
        return base + ("attn", "cpb_fc1", "kernel" if leaf == "weight" else "bias"), (
            "dense" if leaf == "weight" else "none")
    if rest.startswith("attention.self.continuous_position_bias_mlp.2."):
        return base + ("attn", "cpb_fc2", "kernel"), "dense"
    if rest.startswith("attention.output.dense."):
        return base + ("attn", "proj", "kernel" if leaf == "weight" else "bias"), (
            "dense" if leaf == "weight" else "none")
    if rest.startswith("layernorm_before."):
        return base + ("norm1", "scale" if leaf == "weight" else "bias"), "none"
    if rest.startswith("layernorm_after."):
        return base + ("norm2", "scale" if leaf == "weight" else "bias"), "none"
    if rest.startswith("intermediate.dense."):
        return base + ("mlp_fc1", "kernel" if leaf == "weight" else "bias"), (
            "dense" if leaf == "weight" else "none")
    if rest.startswith("output.dense."):
        return base + ("mlp_fc2", "kernel" if leaf == "weight" else "bias"), (
            "dense" if leaf == "weight" else "none")
    if "relative_position_index" in rest or "relative_coords_table" in rest:
        return "skip"
    return None


def map_vit_key(key: str):
    """DINOv2 / plain-ViT state-dict key -> flax path (shared module)."""
    if key == "embeddings.cls_token":
        return ("cls_token",), "none"
    if key == "embeddings.position_embeddings":
        return ("position_embeddings",), "none"
    if key == "embeddings.register_tokens":
        return ("register_tokens",), "none"
    if key == "embeddings.mask_token":
        return "skip"
    if key.startswith("embeddings.patch_embeddings.projection."):
        leaf = key.rsplit(".", 1)[1]
        return ("patch_embed", "kernel" if leaf == "weight" else "bias"), (
            "conv" if leaf == "weight" else "none")
    if key.startswith("layernorm."):  # final norm (backbone / ViTModel)
        leaf = key.rsplit(".", 1)[1]
        return ("final_norm", "scale" if leaf == "weight" else "bias"), "none"
    if key.startswith("pooler."):
        return "skip"
    m = re.match(r"encoder\.layer\.(\d+)\.(.+)$", key)
    if not m:
        return None
    i, rest = int(m[1]), m[2]
    base = (f"block{i}",)
    leaf = rest.rsplit(".", 1)[1]
    dense_t = "dense" if leaf == "weight" else "none"
    for probe, path in (
        ("attention.attention.query.", ("attn", "query")),
        ("attention.attention.key.", ("attn", "key")),
        ("attention.attention.value.", ("attn", "value")),
        ("attention.output.dense.", ("attn", "proj")),
    ):
        if rest.startswith(probe):
            return base + path + ("kernel" if leaf == "weight" else "bias",), dense_t
    for probe, name in (
        ("norm1.", "norm1"), ("norm2.", "norm2"),
        ("layernorm_before.", "norm1"), ("layernorm_after.", "norm2"),
    ):
        if rest.startswith(probe):
            return base + (name, "scale" if leaf == "weight" else "bias"), "none"
    for probe, name in (
        ("mlp.fc1.", "mlp_fc1"), ("mlp.fc2.", "mlp_fc2"),
        ("intermediate.dense.", "mlp_fc1"), ("output.dense.", "mlp_fc2"),
        ("mlp.weights_in.", "swiglu_in"), ("mlp.weights_out.", "swiglu_out"),
    ):
        if rest.startswith(probe):
            return base + (name, "kernel" if leaf == "weight" else "bias"), dense_t
    if rest == "layer_scale1.lambda1":
        return base + ("ls1",), "none"
    if rest == "layer_scale2.lambda1":
        return base + ("ls2",), "none"
    return None


def build_swinv2_encoder(arch_cfg: Dict[str, Any], in_channels: int = 3) -> Swinv2Encoder:
    return Swinv2Encoder(
        in_channels,
        embed_dim=int(arch_cfg.get("embed_dim", 96)),
        depths=tuple(arch_cfg.get("depths", (2, 2, 6, 2))),
        num_heads=tuple(arch_cfg.get("num_heads", (3, 6, 12, 24))),
        window_size=int(arch_cfg.get("window_size", 7)),
        patch_size=int(arch_cfg.get("patch_size", 4)),
        mlp_ratio=float(arch_cfg.get("mlp_ratio", 4.0)),
        qkv_bias=bool(arch_cfg.get("qkv_bias", True)),
        layer_norm_eps=float(arch_cfg.get("layer_norm_eps", 1e-5)),
        image_size=int(arch_cfg.get("image_size", 224)),
        pretrained_window_sizes=tuple(arch_cfg.get("pretrained_window_sizes", (0, 0, 0, 0))))


def build_vit_encoder(arch_cfg: Dict[str, Any], in_channels: int = 3) -> ViTEncoder:
    mt = arch_cfg.get("model_type", "dinov2")
    is_dinov2 = mt.startswith("dinov2")
    hidden = int(arch_cfg.get("hidden_size", 384))
    if is_dinov2:
        # Dinov2MLP sizes its hidden layer from mlp_ratio, ignoring the
        # config's intermediate_size field.
        intermediate = int(hidden * float(arch_cfg.get("mlp_ratio", 4)))
    else:
        intermediate = int(arch_cfg.get("intermediate_size", 4 * hidden))
    return ViTEncoder(
        in_channels,
        hidden_size=hidden,
        num_layers=int(arch_cfg.get("num_hidden_layers", 12)),
        num_heads=int(arch_cfg.get("num_attention_heads", 6)),
        intermediate_size=intermediate,
        patch_size=int(arch_cfg.get("patch_size", 14 if is_dinov2 else 16)),
        image_size=int(arch_cfg.get("image_size", 518 if is_dinov2 else 224)),
        num_register_tokens=int(arch_cfg.get("num_register_tokens", 0)),
        use_layerscale=is_dinov2,
        use_swiglu=bool(arch_cfg.get("use_swiglu_ffn", False)),
        qkv_bias=bool(arch_cfg.get("qkv_bias", True)),
        layer_norm_eps=float(arch_cfg.get("layer_norm_eps", 1e-6)))
