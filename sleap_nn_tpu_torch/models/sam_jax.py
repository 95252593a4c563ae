"""SAM (Segment Anything) as PyTorch modules: the PyTorch counterpart of
``sleap_nn_tpu/models/sam_jax.py``.

The whole SAM graph (the ViT-det image encoder, the prompt encoder and the
two-way-transformer mask decoder) runs on one device, NHWC end to end as
in the JAX module, in float32 or bfloat16. Its matrix products are plain
``torch`` matmuls and einsums: the JAX module computes them outside any
Pallas kernel.

The modules carry the flat upstream key names (``vision_encoder.layers.0.
attn.qkv.weight``, ...) in PyTorch layouts, so ``SamModel(arch).
load_state_dict`` takes a Hugging Face SAM snapshot's tensors as they are
(``strict=True``). The JAX package's flat params map here through
``weights.sam_params_to_torch``.

The arithmetic follows the JAX module step by step: ``q`` scaled before
``QK^T``, the decomposed relative positions added before a float32
softmax whose result is cast back to ``q``'s dtype, windows zero-padded
after ``layer_norm1`` with no attention mask, the relative-position tables
resampled off their grid as ``jax.image.resize(..., "linear")`` does
(with its antialiasing when it shrinks), erf GELU, and the mask decoder's
2x2 stride-2 transposed convolutions as the block-expanding einsum.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclass(frozen=True)
class SamArch:
    """Static architecture hyperparameters (defaults = ``facebook/sam-vit-base``)."""

    # vision encoder
    image_size: int = 1024
    patch_size: int = 16
    num_channels: int = 3
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_dim: int = 3072
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    use_rel_pos: bool = True
    use_abs_pos: bool = True
    output_channels: int = 256
    layer_norm_eps: float = 1e-6
    # prompt encoder / mask decoder (share hidden size = output_channels)
    num_pos_feats: int = 128
    decoder_hidden: int = 256
    decoder_layers: int = 2
    decoder_heads: int = 8
    decoder_mlp_dim: int = 2048
    num_multimask_outputs: int = 3
    iou_head_depth: int = 3
    iou_head_hidden_dim: int = 256
    attention_downsample_rate: int = 2
    mask_input_channels: int = 16

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @classmethod
    def from_hf_config(cls, config) -> "SamArch":
        """Build from a ``transformers.SamConfig`` (object or nested dict)."""
        if isinstance(config, dict):
            v = config.get("vision_config", {})
            d = config.get("mask_decoder_config", {})
            p = config.get("prompt_encoder_config", {})

            def g(src, key, default):
                return src.get(key, default)
        else:
            v, d, p = (config.vision_config, config.mask_decoder_config,
                       config.prompt_encoder_config)

            def g(src, key, default):
                return getattr(src, key, default)

        return cls(
            image_size=g(v, "image_size", 1024),
            patch_size=g(v, "patch_size", 16),
            num_channels=g(v, "num_channels", 3),
            hidden_size=g(v, "hidden_size", 768),
            num_hidden_layers=g(v, "num_hidden_layers", 12),
            num_attention_heads=g(v, "num_attention_heads", 12),
            mlp_dim=g(v, "mlp_dim", 3072),
            window_size=g(v, "window_size", 14),
            global_attn_indexes=tuple(g(v, "global_attn_indexes", (2, 5, 8, 11))),
            use_rel_pos=g(v, "use_rel_pos", True),
            use_abs_pos=g(v, "use_abs_pos", True),
            output_channels=g(v, "output_channels", 256),
            layer_norm_eps=g(v, "layer_norm_eps", 1e-6),
            num_pos_feats=g(v, "num_pos_feats", 128),
            decoder_hidden=g(d, "hidden_size", 256),
            decoder_layers=g(d, "num_hidden_layers", 2),
            decoder_heads=g(d, "num_attention_heads", 8),
            decoder_mlp_dim=g(d, "mlp_dim", 2048),
            num_multimask_outputs=g(d, "num_multimask_outputs", 3),
            iou_head_depth=g(d, "iou_head_depth", 3),
            iou_head_hidden_dim=g(d, "iou_head_hidden_dim", 256),
            attention_downsample_rate=g(d, "attention_downsample_rate", 2),
            mask_input_channels=g(p, "mask_input_channels", 16),
        )


# ── Weight import ────────────────────────────────────────────────────────────

# The one tensor upstream ties: the prompt encoder's Fourier table is the
# model's shared one, and a snapshot may store it once.
TIED_KEYS = {"prompt_encoder.shared_embedding.positional_embedding":
             "shared_image_embedding.positional_embedding"}


def convert_sam_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """An upstream ``SamModel`` state dict (torch tensors or numpy arrays,
    as a snapshot's ``model.safetensors`` holds them) -> float32 tensors
    that ``SamModel.load_state_dict`` takes, in the same PyTorch layouts.
    A tied key the snapshot stored once is filled from its twin."""
    out = {}
    for k, v in state_dict.items():
        if torch.is_tensor(v):
            out[k] = v.detach().float()
        else:
            a = np.asarray(v, dtype=np.float32)
            out[k] = torch.from_numpy(a if a.flags.writeable else a.copy())
    for tied, src in TIED_KEYS.items():
        if tied not in out and src in out:
            out[tied] = out[src]
    return out


def _layer_norm(norm: nn.LayerNorm, x: torch.Tensor, eps: float) -> torch.Tensor:
    return F.layer_norm(x, norm.weight.shape, norm.weight, norm.bias, eps)


def _upscale2x(conv: nn.ConvTranspose2d, x: torch.Tensor) -> torch.Tensor:
    """Exact 2x2-stride-2 ConvTranspose2d: per-pixel 2x2 block expansion."""
    w = conv.weight  # (in, out, 2, 2)
    b, h, wd, _ = x.shape
    out = torch.einsum("bhwc,coij->bhiwjo", x, w)
    return out.reshape(b, h * 2, wd * 2, w.shape[1]) + conv.bias


# ── Vision encoder ───────────────────────────────────────────────────────────


def _linear_resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) weights of ``jax.image.resize(..., "linear")`` along one
    axis (``scale_and_translate`` with the triangle kernel, widened by the
    scale when it shrinks, normalised per output sample), in float32."""
    inv_scale = np.float32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, np.float32(1.0))
    sample = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * inv_scale - np.float32(0.5)
    x = np.abs(sample[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - x)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _get_rel_pos(rel_pos: torch.Tensor, q_size: int, k_size: int) -> torch.Tensor:
    """Slice (and, off the pretrain grid, linearly resample) relative positions."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        w = torch.from_numpy(_linear_resize_matrix(rel_pos.shape[0], max_rel_dist))
        rel_pos = torch.einsum("ic,io->oc", rel_pos, w.to(rel_pos.device, rel_pos.dtype))
    # float64 on the device, as the JAX module's numpy index arithmetic
    # (no host-to-device copy, which would wait for the card).
    f64 = dict(dtype=torch.float64, device=rel_pos.device)
    q_coords = torch.arange(q_size, **f64)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, **f64)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long()]


class SamVisionAttention(nn.Module):
    """Windowed or global multi-head attention with decomposed relative positions."""

    def __init__(self, arch: SamArch, input_size: int):
        super().__init__()
        c, nh = arch.hidden_size, arch.num_attention_heads
        self.num_heads, self.use_rel_pos = nh, arch.use_rel_pos
        self.qkv = nn.Linear(c, 3 * c)
        self.proj = nn.Linear(c, c)
        if arch.use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size - 1, c // nh))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size - 1, c // nh))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        nh = self.num_heads
        hd = c // nh
        qkv = self.qkv(x.reshape(b, h * w, c))
        qkv = qkv.reshape(b, h * w, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * nh, h * w, hd).unbind(0)

        attn = (q * hd ** -0.5) @ k.transpose(1, 2)
        if self.use_rel_pos:
            rh = _get_rel_pos(self.rel_pos_h, h, h)
            rw = _get_rel_pos(self.rel_pos_w, w, w)
            rq = q.reshape(b * nh, h, w, hd)
            rel_h = torch.einsum("bhwc,hkc->bhwk", rq, rh)
            rel_w = torch.einsum("bhwc,wkc->bhwk", rq, rw)
            # In place: a global layer's (heads, 4096, 4096) matrix is 1 GB in f32.
            attn.view(b * nh, h, w, h, w).add_(
                rel_h[:, :, :, :, None] + rel_w[:, :, :, None, :])
        attn = torch.softmax(attn.float(), dim=-1).to(q.dtype)
        out = (attn @ v).reshape(b, nh, h, w, hd)
        return self.proj(out.permute(0, 2, 3, 1, 4).reshape(b, h, w, c))


def _window_partition(x: torch.Tensor, ws: int):
    b, h, w, c = x.shape
    pad_h = (ws - h % ws) % ws
    pad_w = (ws - w % ws) % ws
    x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    ph, pw = h + pad_h, w + pad_w
    x = x.reshape(b, ph // ws, ws, pw // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (ph, pw)


def _window_unpartition(wins: torch.Tensor, ws: int, padded, original):
    ph, pw = padded
    h, w = original
    c = wins.shape[-1]
    b = wins.shape[0] // ((ph // ws) * (pw // ws))
    x = wins.reshape(b, ph // ws, pw // ws, ws, ws, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, ph, pw, c)
    return x[:, :h, :w, :]


class SamMLP(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)


class SamVisionLayer(nn.Module):
    def __init__(self, arch: SamArch, window_size: int):
        super().__init__()
        c = arch.hidden_size
        self.window_size, self.eps = window_size, arch.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(c)
        self.attn = SamVisionAttention(arch, window_size if window_size > 0 else arch.grid)
        self.layer_norm2 = nn.LayerNorm(c)
        self.mlp = SamMLP(c, arch.mlp_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = _layer_norm(self.layer_norm1, x, self.eps)
        if self.window_size > 0:
            h, w = x.shape[1], x.shape[2]
            x, padded = _window_partition(x, self.window_size)
            x = _window_unpartition(self.attn(x), self.window_size, padded, (h, w))
        else:
            x = self.attn(x)
        x = residual + x
        y = _layer_norm(self.layer_norm2, x, self.eps)
        y = self.mlp.lin2(F.gelu(self.mlp.lin1(y)))
        return x + y


class SamPatchEmbed(nn.Module):
    def __init__(self, arch: SamArch):
        super().__init__()
        self.projection = nn.Conv2d(arch.num_channels, arch.hidden_size, arch.patch_size,
                                    arch.patch_size)


class SamNeck(nn.Module):
    def __init__(self, arch: SamArch):
        super().__init__()
        c, o = arch.hidden_size, arch.output_channels
        self.conv1 = nn.Conv2d(c, o, 1, bias=False)
        self.layer_norm1 = nn.LayerNorm(o)
        self.conv2 = nn.Conv2d(o, o, 3, padding=1, bias=False)
        self.layer_norm2 = nn.LayerNorm(o)


def _conv_nhwc(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


class SamVisionEncoder(nn.Module):
    """(B, H, W, 3) preprocessed image -> (B, grid, grid, output_channels)."""

    def __init__(self, arch: SamArch):
        super().__init__()
        self.arch = arch
        self.patch_embed = SamPatchEmbed(arch)
        if arch.use_abs_pos:
            self.pos_embed = nn.Parameter(torch.zeros(1, arch.grid, arch.grid, arch.hidden_size))
        self.layers = nn.ModuleList(
            SamVisionLayer(arch, 0 if i in arch.global_attn_indexes else arch.window_size)
            for i in range(arch.num_hidden_layers))
        self.neck = SamNeck(arch)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        x = _conv_nhwc(self.patch_embed.projection, pixel_values)
        if self.arch.use_abs_pos:
            x = x + self.pos_embed
        for layer in self.layers:
            x = layer(x)
        # neck: 1x1 conv -> LN -> 3x3 conv -> LN (channel-last LN in NHWC)
        x = _layer_norm(self.neck.layer_norm1, _conv_nhwc(self.neck.conv1, x), 1e-6)
        return _layer_norm(self.neck.layer_norm2, _conv_nhwc(self.neck.conv2, x), 1e-6)


def sam_image_encoder(model: "SamModel", arch: SamArch, pixel_values: torch.Tensor
                      ) -> torch.Tensor:
    """(B, H, W, 3) preprocessed image -> (B, grid, grid, output_channels)."""
    return model.vision_encoder(pixel_values)


# ── Prompt encoder ───────────────────────────────────────────────────────────


class SamPositionalEmbedding(nn.Module):
    def __init__(self, arch: SamArch):
        super().__init__()
        self.register_buffer("positional_embedding",
                             torch.zeros(2, arch.decoder_hidden // 2))


class SamMaskEmbedding(nn.Module):
    """Upstream's dense mask-prompt embedding. The graph takes no mask
    prompt, as the JAX module takes none; its weights are kept so that a
    snapshot loads whole."""

    def __init__(self, arch: SamArch):
        super().__init__()
        m = arch.mask_input_channels
        self.conv1 = nn.Conv2d(1, m // 4, 2, 2)
        self.conv2 = nn.Conv2d(m // 4, m, 2, 2)
        self.conv3 = nn.Conv2d(m, arch.decoder_hidden, 1)
        self.layer_norm1 = nn.LayerNorm(m // 4)
        self.layer_norm2 = nn.LayerNorm(m)


class SamPromptEncoder(nn.Module):
    def __init__(self, arch: SamArch, shared_embedding: SamPositionalEmbedding):
        super().__init__()
        c = arch.decoder_hidden
        self.shared_embedding = shared_embedding
        self.mask_embed = SamMaskEmbedding(arch)
        self.no_mask_embed = nn.Embedding(1, c)
        self.point_embed = nn.ModuleList(nn.Embedding(1, c) for _ in range(4))
        self.not_a_point_embed = nn.Embedding(1, c)


def _fourier_embed(model: "SamModel", coords01: torch.Tensor) -> torch.Tensor:
    """[0,1]-normalized coords (..., 2) -> (..., 2*num_pos_feats)."""
    pe = model.shared_image_embedding.positional_embedding  # (2, F)
    c = (2.0 * coords01 - 1.0) @ pe.to(coords01.dtype)
    c = 2.0 * np.pi * c
    return torch.cat([torch.sin(c), torch.cos(c)], dim=-1)


def _embed_points(model: "SamModel", arch: SamArch, points: torch.Tensor,
                  labels: torch.Tensor, pad: bool) -> torch.Tensor:
    """(B, P, N, 2) pixel coords + (B, P, N) labels -> (B, P, N[+1], C).

    Label semantics follow the upstream port: 1 = foreground, 0 = background,
    -1 = "not a point" (padding point added when no box accompanies the
    points), -10 = processor padding (embedding zeroed).
    """
    pe = model.prompt_encoder
    points = points + 0.5
    if pad:
        points = torch.cat([points, points.new_zeros((*points.shape[:2], 1, 2))], dim=2)
        labels = torch.cat([labels, -labels.new_ones((*labels.shape[:2], 1))], dim=2)
    emb = _fourier_embed(model, points / arch.image_size)
    lab = labels[..., None]
    emb = torch.where(lab == -1, pe.not_a_point_embed.weight[0].to(emb.dtype), emb)
    emb = torch.where(lab == -10, torch.zeros_like(emb), emb)
    emb = torch.where(lab == 0, emb + pe.point_embed[0].weight[0], emb)
    return torch.where(lab == 1, emb + pe.point_embed[1].weight[0], emb)


def _embed_boxes(model: "SamModel", arch: SamArch, boxes: torch.Tensor) -> torch.Tensor:
    """(B, nb, 4) xyxy pixel boxes -> (B, nb, 2, C) corner embeddings."""
    b, nb = boxes.shape[:2]
    corners = (boxes + 0.5).reshape(b, nb, 2, 2)
    emb = _fourier_embed(model, corners / arch.image_size)
    pe = model.prompt_encoder.point_embed
    return torch.stack([emb[:, :, 0] + pe[2].weight[0], emb[:, :, 1] + pe[3].weight[0]], dim=2)


def sam_prompt_encoder(
    model: "SamModel",
    arch: SamArch,
    input_points: Optional[torch.Tensor],
    input_labels: Optional[torch.Tensor],
    input_boxes: Optional[torch.Tensor],
    batch_size: int,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """-> (sparse (B, P, T, C) or None, dense (B, grid, grid, C))."""
    sparse = None
    if input_points is not None:
        sparse = _embed_points(model, arch, input_points, input_labels,
                               pad=input_boxes is None)
    if input_boxes is not None:
        box_emb = _embed_boxes(model, arch, input_boxes)
        sparse = box_emb if sparse is None else torch.cat([sparse, box_emb], dim=2)
    dense = model.prompt_encoder.no_mask_embed.weight.reshape(1, 1, 1, -1).expand(
        batch_size, arch.grid, arch.grid, arch.decoder_hidden)
    return sparse, dense


def image_grid_positional_embedding(model: "SamModel", arch: SamArch) -> torch.Tensor:
    """Dense per-cell Fourier positions of the embedding grid -> (grid, grid, C),
    in the model's dtype."""
    size = arch.grid
    pe = model.shared_image_embedding.positional_embedding
    coords = (torch.arange(size, dtype=torch.float32, device=pe.device) + 0.5) / size
    grid = torch.stack([coords[None, :].expand(size, size), coords[:, None].expand(size, size)],
                       dim=-1)
    return _fourier_embed(model, grid).to(model.mask_decoder.iou_token.weight.dtype)


# ── Mask decoder ─────────────────────────────────────────────────────────────


class SamAttention(nn.Module):
    """SamAttention: (B, P, T, C) tensors, optional internal downsampling."""

    def __init__(self, dim: int, num_heads: int, downsample_rate: int = 1):
        super().__init__()
        inner = dim // downsample_rate
        self.num_heads = num_heads
        self.q_proj = nn.Linear(dim, inner)
        self.k_proj = nn.Linear(dim, inner)
        self.v_proj = nn.Linear(dim, inner)
        self.out_proj = nn.Linear(inner, dim)

    def forward(self, query, key, value):
        q, k, v = self.q_proj(query), self.k_proj(key), self.v_proj(value)
        b, p, tq, ci = q.shape
        tk = k.shape[2]
        nh = self.num_heads
        hd = ci // nh

        def split(t, n):
            return t.reshape(b * p, n, nh, hd).transpose(1, 2)

        qh, kh, vh = split(q, tq), split(k, tk), split(v, tk)
        attn = (qh @ kh.transpose(2, 3)) * hd ** -0.5
        attn = torch.softmax(attn.float(), dim=-1).to(qh.dtype)
        out = (attn @ vh).transpose(1, 2).reshape(b, p, tq, ci)
        return self.out_proj(out)


class SamTwoWayBlock(nn.Module):
    def __init__(self, arch: SamArch):
        super().__init__()
        c, nh, r = arch.decoder_hidden, arch.decoder_heads, arch.attention_downsample_rate
        self.eps = arch.layer_norm_eps
        self.self_attn = SamAttention(c, nh)
        self.layer_norm1 = nn.LayerNorm(c)
        self.cross_attn_token_to_image = SamAttention(c, nh, r)
        self.layer_norm2 = nn.LayerNorm(c)
        self.mlp = SamMLP(c, arch.decoder_mlp_dim)
        self.layer_norm3 = nn.LayerNorm(c)
        self.layer_norm4 = nn.LayerNorm(c)
        self.cross_attn_image_to_token = SamAttention(c, nh, r)

    def forward(self, queries, keys, query_pe, key_pe, skip_first_layer_pe: bool):
        eps = self.eps
        if skip_first_layer_pe:  # the first layer's self-attention replaces the queries
            queries = self.self_attn(queries, queries, queries)
        else:
            q = queries + query_pe
            queries = queries + self.self_attn(q, q, queries)
        queries = _layer_norm(self.layer_norm1, queries, eps)

        q, k = queries + query_pe, keys + key_pe
        queries = queries + self.cross_attn_token_to_image(q, k, keys)
        queries = _layer_norm(self.layer_norm2, queries, eps)

        y = self.mlp.lin2(torch.relu(self.mlp.lin1(queries)))
        queries = _layer_norm(self.layer_norm3, queries + y, eps)

        q, k = queries + query_pe, keys + key_pe
        keys = keys + self.cross_attn_image_to_token(k, q, queries)
        return queries, _layer_norm(self.layer_norm4, keys, eps)


class SamTwoWayTransformer(nn.Module):
    def __init__(self, arch: SamArch):
        super().__init__()
        c = arch.decoder_hidden
        self.layers = nn.ModuleList(SamTwoWayBlock(arch) for _ in range(arch.decoder_layers))
        self.final_attn_token_to_image = SamAttention(c, arch.decoder_heads,
                                                      arch.attention_downsample_rate)
        self.layer_norm_final_attn = nn.LayerNorm(c)


class SamFeedForward(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int, depth: int):
        super().__init__()
        self.proj_in = nn.Linear(dim, hidden)
        self.layers = nn.ModuleList(nn.Linear(hidden, hidden) for _ in range(depth - 2))
        self.proj_out = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.proj_in(x))
        for layer in self.layers:
            x = torch.relu(layer(x))
        return self.proj_out(x)


class SamMaskDecoder(nn.Module):
    def __init__(self, arch: SamArch):
        super().__init__()
        c, k = arch.decoder_hidden, arch.num_multimask_outputs + 1
        self.iou_token = nn.Embedding(1, c)
        self.mask_tokens = nn.Embedding(k, c)
        self.transformer = SamTwoWayTransformer(arch)
        self.upscale_conv1 = nn.ConvTranspose2d(c, c // 4, 2, 2)
        self.upscale_conv2 = nn.ConvTranspose2d(c // 4, c // 8, 2, 2)
        self.upscale_layer_norm = nn.LayerNorm(c // 4)
        self.output_hypernetworks_mlps = nn.ModuleList(
            SamFeedForward(c, c, c // 8, 3) for _ in range(k))
        self.iou_prediction_head = SamFeedForward(c, arch.iou_head_hidden_dim, k,
                                                  arch.iou_head_depth)


def sam_mask_decoder(
    model: "SamModel",
    arch: SamArch,
    image_embeddings: torch.Tensor,   # (B, grid, grid, C) NHWC
    sparse_prompt: Optional[torch.Tensor],  # (B, P, T, C)
    dense_prompt: torch.Tensor,       # (B, grid, grid, C)
    multimask_output: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """-> (low-res masks (B, P, K, 4*grid, 4*grid), iou scores (B, P, K))."""
    dec = model.mask_decoder
    tf = dec.transformer
    b, gh, gw, c = image_embeddings.shape
    p = sparse_prompt.shape[1] if sparse_prompt is not None else 1
    n_mask_tokens = arch.num_multimask_outputs + 1

    output_tokens = torch.cat([dec.iou_token.weight, dec.mask_tokens.weight], dim=0)  # (1+K, C)
    tokens = output_tokens.expand(b, p, *output_tokens.shape)
    if sparse_prompt is not None:
        tokens = torch.cat([tokens, sparse_prompt], dim=2)

    src = image_embeddings + dense_prompt
    # (B*P, 1, HW, C): the image's keys repeated once per prompt.
    keys = src.reshape(b, 1, gh * gw, c).repeat_interleave(p, dim=0)
    key_pe = image_grid_positional_embedding(model, arch).reshape(1, 1, gh * gw, c).expand(
        keys.shape)

    queries = tokens
    for i, layer in enumerate(tf.layers):
        queries, keys = layer(queries, keys, tokens, key_pe, skip_first_layer_pe=(i == 0))
    q, k = queries + tokens, keys + key_pe
    queries = queries + tf.final_attn_token_to_image(q, k, keys)
    # upstream uses nn.LayerNorm's default eps here
    queries = _layer_norm(tf.layer_norm_final_attn, queries, 1e-5)

    iou_token_out = queries[:, :, 0, :]
    mask_tokens_out = queries[:, :, 1:1 + n_mask_tokens, :]

    up = _upscale2x(dec.upscale_conv1, keys.reshape(b * p, gh, gw, c))
    up = F.gelu(_layer_norm(dec.upscale_layer_norm, up, 1e-6))
    up = F.gelu(_upscale2x(dec.upscale_conv2, up))

    hyper = torch.stack([mlp(mask_tokens_out[:, :, i, :])
                         for i, mlp in enumerate(dec.output_hypernetworks_mlps)],
                        dim=2)  # (B, P, K+1, C/8)
    uh, uw, uc = up.shape[1], up.shape[2], up.shape[3]
    flat = up.reshape(b, p, uh * uw, uc)
    masks = torch.einsum("bpkc,bpnc->bpkn", hyper, flat).reshape(b, p, -1, uh, uw)

    iou_pred = dec.iou_prediction_head(iou_token_out)
    sl = slice(1, None) if multimask_output else slice(0, 1)
    return masks[:, :, sl], iou_pred[:, :, sl]


# ── The model ────────────────────────────────────────────────────────────────


class SamModel(nn.Module):
    """The SAM graph whose ``state_dict`` keys and shapes are upstream
    ``SamModel``'s: a snapshot's tensors load with ``strict=True``."""

    def __init__(self, arch: SamArch):
        super().__init__()
        self.arch = arch
        self.shared_image_embedding = SamPositionalEmbedding(arch)
        self.vision_encoder = SamVisionEncoder(arch)
        self.prompt_encoder = SamPromptEncoder(arch, self.shared_image_embedding)
        self.mask_decoder = SamMaskDecoder(arch)

    @classmethod
    def from_state_dict(cls, arch: SamArch, state_dict: Mapping) -> "SamModel":
        """A model of ``arch`` holding ``state_dict`` (upstream keys, PyTorch
        layouts, tensors or arrays), loaded strictly. The modules are built
        on the meta device and take the tensors as they are: a ViT-H's 641 M
        parameters are neither initialised nor copied."""
        with torch.device("meta"):
            model = cls(arch)
        model.load_state_dict(convert_sam_state_dict(state_dict), strict=True, assign=True)
        return model.eval()


def sam_predict(
    model: SamModel,
    arch: SamArch,
    pixel_values: torch.Tensor,
    input_points: Optional[torch.Tensor] = None,
    input_labels: Optional[torch.Tensor] = None,
    input_boxes: Optional[torch.Tensor] = None,
    multimask_output: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full SAM forward: preprocessed NHWC image + prompts -> (masks, iou)."""
    embeddings = sam_image_encoder(model, arch, pixel_values)
    return sam_decode(model, arch, embeddings, input_points, input_labels,
                      input_boxes, multimask_output)


def sam_decode(
    model: SamModel,
    arch: SamArch,
    image_embeddings: torch.Tensor,
    input_points: Optional[torch.Tensor] = None,
    input_labels: Optional[torch.Tensor] = None,
    input_boxes: Optional[torch.Tensor] = None,
    multimask_output: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prompt-encode + mask-decode against cached image embeddings."""
    if input_points is not None and input_labels is None:
        input_labels = torch.ones(input_points.shape[:3], dtype=torch.int32,
                                  device=input_points.device)
    sparse, dense = sam_prompt_encoder(
        model, arch, input_points, input_labels, input_boxes,
        batch_size=image_embeddings.shape[0],
    )
    return sam_mask_decoder(model, arch, image_embeddings, sparse, dense, multimask_output)
