"""Pretrained image backbones (HuggingFace checkpoints) as torch encoders.

Port of ``sleap_nn_tpu/models/pretrained.py``: a hierarchical encoder
(ConvNeXtV2, ResNet, Swinv2) feeds a SLEAP decoder built from a shape probe
of its feature pyramid ("decoder" mode), or an isotropic ViT / DINOv2
exposes its one bottleneck map and every head binds there ("encoder"
mode). The input is normalized by the model's mean and std inside
``forward``; ResNet BatchNorm always uses its running statistics.

Weights come from a LOCAL snapshot (a downloaded HF model dir, or the HF
hub cache): ``*.safetensors`` files read by this module's own reader (an
8-byte header length, a JSON header, raw little-endian buffers), else a
``pytorch_model.bin``. With no snapshot ``load_hf_encoder_params`` warns
and keeps the random init, as the JAX package does. The HF checkpoint is
torch's own layout, so a tensor goes to its ``state_dict`` key as it is.

Modules are named after the JAX package's flax tree (``encoder``,
``encoder.inner`` under ``out_indices``, ``encoder.stage0_block0.conv0``,
``dec``), so ``weights.flax_to_torch_state`` maps each leaf by its path.
The probe runs the encoder on the ``meta`` device at 448x448: shapes only.
"""

from __future__ import annotations

import json
import math
import re
import warnings
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sleap_nn_tpu_torch.models.encoder_decoder import (
    Decoder,
    conv_nhwc,
    conv_nhwc_same,
    decoder_block_filters,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# Offline architecture configs for the recommended model ids
# (hyperparameters from the public model cards, not weights).
_BUILTIN_CONFIGS = {
    "convnextv2-atto": {"model_type": "convnextv2", "depths": [2, 2, 6, 2], "hidden_sizes": [40, 80, 160, 320]},
    "convnextv2-femto": {"model_type": "convnextv2", "depths": [2, 2, 6, 2], "hidden_sizes": [48, 96, 192, 384]},
    "convnextv2-pico": {"model_type": "convnextv2", "depths": [2, 2, 6, 2], "hidden_sizes": [64, 128, 256, 512]},
    "convnextv2-nano": {"model_type": "convnextv2", "depths": [2, 2, 8, 2], "hidden_sizes": [80, 160, 320, 640]},
    "convnextv2-tiny": {"model_type": "convnextv2", "depths": [3, 3, 9, 3], "hidden_sizes": [96, 192, 384, 768]},
    "resnet-18": {"model_type": "resnet", "depths": [2, 2, 2, 2], "hidden_sizes": [64, 128, 256, 512], "embedding_size": 64, "layer_type": "basic"},
    "resnet-50": {"model_type": "resnet", "depths": [3, 4, 6, 3], "hidden_sizes": [256, 512, 1024, 2048], "embedding_size": 64, "layer_type": "bottleneck"},
    "swinv2-tiny": {"model_type": "swinv2", "embed_dim": 96, "depths": [2, 2, 6, 2], "num_heads": [3, 6, 12, 24], "window_size": 8, "image_size": 256},
    "swinv2-small": {"model_type": "swinv2", "embed_dim": 96, "depths": [2, 2, 18, 2], "num_heads": [3, 6, 12, 24], "window_size": 8, "image_size": 256},
    "swinv2-base": {"model_type": "swinv2", "embed_dim": 128, "depths": [2, 2, 18, 2], "num_heads": [4, 8, 16, 32], "window_size": 8, "image_size": 256},
    "dinov2-small": {"model_type": "dinov2", "hidden_size": 384, "num_hidden_layers": 12, "num_attention_heads": 6, "intermediate_size": 1536, "patch_size": 14, "image_size": 518},
    "dinov2-base": {"model_type": "dinov2", "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072, "patch_size": 14, "image_size": 518},
    "vit-base-patch16": {"model_type": "vit", "hidden_size": 768, "num_hidden_layers": 12, "num_attention_heads": 12, "intermediate_size": 3072, "patch_size": 16, "image_size": 224},
}


def find_local_snapshot(model_name: str, revision: Optional[str] = None) -> Optional[Path]:
    """A local HF snapshot dir of ``model_name`` (no network), or None.

    ``model_name`` may be the dir itself; else the HF hub cache
    (``~/.cache/huggingface/hub/models--org--name/snapshots/*``) is
    searched. ``revision`` pins a snapshot by commit prefix (an absent one
    raises ``FileNotFoundError``); unset picks the newest.
    """
    p = Path(model_name)
    if p.is_dir() and (p / "config.json").exists():
        return p
    cache = Path.home() / ".cache/huggingface/hub"
    slug = "models--" + model_name.replace("/", "--")
    snaps = sorted((cache / slug / "snapshots").glob("*")) if (cache / slug).exists() else []
    if revision:
        pinned = [s for s in snaps if s.name.startswith(revision)]
        if not pinned:
            raise FileNotFoundError(
                f"No local snapshot of {model_name!r} at revision "
                f"{revision!r} (found: {[s.name[:12] for s in snaps]}).")
        snaps = pinned
    for snap in reversed(snaps):
        if (snap / "config.json").exists():
            return snap
    return None


def resolve_hf_config(model_name: str, revision: Optional[str] = None,
                      ) -> Tuple[Dict[str, Any], Optional[Path]]:
    """(architecture config dict, local snapshot path or None)."""
    snap = find_local_snapshot(model_name, revision=revision)
    if snap is not None:
        with open(snap / "config.json") as fp:
            return json.load(fp), snap
    for key, cfg in _BUILTIN_CONFIGS.items():
        if key in model_name:
            return dict(cfg), None
    raise ValueError(
        f"Cannot resolve pretrained backbone {model_name!r}: no local "
        f"snapshot found and no built-in architecture config matches. "
        f"Download the model to a directory and pass its path as model_name.")


# ── safetensors ───────────────────────────────────────────────────────────────

_ST_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8", "I32": "<i4",
              "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path) -> Dict[str, np.ndarray]:
    """Every tensor of a ``.safetensors`` file, as numpy arrays (BF16 as
    float32, exactly)."""
    raw = Path(path).read_bytes()
    (n,) = np.frombuffer(raw[:8], "<u8")
    header = json.loads(raw[8:8 + int(n)])
    base = 8 + int(n)
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        b, e = spec["data_offsets"]
        buf = raw[base + b:base + e]
        dt = spec["dtype"]
        if dt == "BF16":
            arr = (np.frombuffer(buf, "<u2").astype(np.uint32) << 16).view(np.float32)
        elif dt in _ST_DTYPES:
            arr = np.frombuffer(buf, _ST_DTYPES[dt])
        else:
            raise NotImplementedError(f"safetensors dtype {dt} ({name!r} in {path})")
        out[name] = arr.reshape(spec["shape"]).copy()
    return out


# ── ConvNeXtV2 ────────────────────────────────────────────────────────────────


class GRN(nn.Module):
    """Global response normalization (ConvNeXtV2), NHWC."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gx = torch.sqrt(torch.sum(torch.square(x), dim=(1, 2), keepdim=True))
        nx = gx / (torch.mean(gx, dim=-1, keepdim=True) + 1e-6)
        return self.weight * (x * nx) + self.bias + x


class ConvNeXtV2Block(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, 4 * dim)
        self.grn = GRN(4 * dim)
        self.pwconv2 = nn.Linear(4 * dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.pwconv1(self.norm(conv_nhwc(self.dwconv, x)))
        return x + self.pwconv2(self.grn(F.gelu(y)))


class ConvNeXtV2Encoder(nn.Module):
    """HF-compatible ConvNeXtV2 backbone returning the 4-stage pyramid
    (each tap LayerNorm'ed, as HF's ``hidden_states_norms``)."""

    def __init__(self, in_channels: int = 3, depths: Sequence[int] = (2, 2, 6, 2),
                 hidden_sizes: Sequence[int] = (40, 80, 160, 320)):
        super().__init__()
        self.depths = tuple(depths)
        self.patch_embed = nn.Conv2d(in_channels, hidden_sizes[0], 4, stride=4)
        self.embed_norm = nn.LayerNorm(hidden_sizes[0], eps=1e-6)
        for s, (depth, dim) in enumerate(zip(depths, hidden_sizes)):
            if s > 0:
                self.add_module(f"stage{s}_down_norm", nn.LayerNorm(hidden_sizes[s - 1], eps=1e-6))
                self.add_module(f"stage{s}_down_conv",
                                nn.Conv2d(hidden_sizes[s - 1], dim, 2, stride=2))
            for i in range(depth):
                self.add_module(f"stage{s}_block{i}", ConvNeXtV2Block(dim))
            self.add_module(f"out_norm{s}", nn.LayerNorm(dim, eps=1e-6))

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.embed_norm(conv_nhwc_same(self.patch_embed, x))
        feats = []
        for s, depth in enumerate(self.depths):
            if s > 0:
                x = getattr(self, f"stage{s}_down_norm")(x)
                x = conv_nhwc_same(getattr(self, f"stage{s}_down_conv"), x)
            for i in range(depth):
                x = getattr(self, f"stage{s}_block{i}")(x)
            feats.append(getattr(self, f"out_norm{s}")(x))
        return feats


# ── ResNet ────────────────────────────────────────────────────────────────────


class FrozenBatchNorm(nn.Module):
    """Channel-last BatchNorm on its running statistics (flax's
    ``BatchNorm(use_running_average=True)``, eps 1e-5)."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        return (x - self.running_mean) * mul + self.bias


def _conv(cin: int, cout: int, k: int, stride: int = 1, padding: int = 0) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=padding, bias=False)


class ResNetBottleneck(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1,
                 reduction: int = 4, downsample_in_bottleneck: bool = False):
        super().__init__()
        mid = out_channels // reduction
        self.shortcut_conv = None
        if in_channels != out_channels or stride != 1:
            self.shortcut_conv = _conv(in_channels, out_channels, 1, stride)
            self.shortcut_bn = FrozenBatchNorm(out_channels)
        s0, s1 = (stride, 1) if downsample_in_bottleneck else (1, stride)
        self.conv0, self.bn0 = _conv(in_channels, mid, 1, s0), FrozenBatchNorm(mid)
        self.conv1, self.bn1 = _conv(mid, mid, 3, s1, 1), FrozenBatchNorm(mid)
        self.conv2, self.bn2 = _conv(mid, out_channels, 1), FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.shortcut_conv is not None:
            shortcut = self.shortcut_bn(conv_nhwc(self.shortcut_conv, x))
        x = torch.relu(self.bn0(conv_nhwc(self.conv0, x)))
        x = torch.relu(self.bn1(conv_nhwc(self.conv1, x)))
        x = self.bn2(conv_nhwc(self.conv2, x))
        return torch.relu(x + shortcut)


class ResNetBasicBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, stride: int = 1):
        super().__init__()
        self.shortcut_conv = None
        if in_channels != out_channels or stride != 1:
            self.shortcut_conv = _conv(in_channels, out_channels, 1, stride)
            self.shortcut_bn = FrozenBatchNorm(out_channels)
        self.conv0, self.bn0 = _conv(in_channels, out_channels, 3, stride, 1), \
            FrozenBatchNorm(out_channels)
        self.conv1, self.bn1 = _conv(out_channels, out_channels, 3, 1, 1), \
            FrozenBatchNorm(out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.shortcut_conv is not None:
            shortcut = self.shortcut_bn(conv_nhwc(self.shortcut_conv, x))
        x = torch.relu(self.bn0(conv_nhwc(self.conv0, x)))
        x = self.bn1(conv_nhwc(self.conv1, x))
        return torch.relu(x + shortcut)


class ResNetEncoder(nn.Module):
    """HF-compatible ResNet backbone returning the 4-stage pyramid."""

    def __init__(self, in_channels: int = 3, depths: Sequence[int] = (3, 4, 6, 3),
                 hidden_sizes: Sequence[int] = (256, 512, 1024, 2048),
                 embedding_size: int = 64, layer_type: str = "bottleneck",
                 downsample_in_first_stage: bool = False,
                 downsample_in_bottleneck: bool = False):
        super().__init__()
        self.depths = tuple(depths)
        self.stem_conv = _conv(in_channels, embedding_size, 7, 2, 3)
        self.stem_bn = FrozenBatchNorm(embedding_size)
        c = embedding_size
        for s, (depth, dim) in enumerate(zip(depths, hidden_sizes)):
            stride = 2 if (s > 0 or downsample_in_first_stage) else 1
            for i in range(depth):
                st = stride if i == 0 else 1
                if layer_type == "bottleneck":
                    block = ResNetBottleneck(c, dim, st,
                                             downsample_in_bottleneck=downsample_in_bottleneck)
                else:
                    block = ResNetBasicBlock(c, dim, st)
                self.add_module(f"stage{s}_block{i}", block)
                c = dim

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = torch.relu(self.stem_bn(conv_nhwc(self.stem_conv, x)))
        x = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, padding=1).permute(0, 2, 3, 1)
        feats = []
        for s, depth in enumerate(self.depths):
            for i in range(depth):
                x = getattr(self, f"stage{s}_block{i}")(x)
            feats.append(x)
        return feats


# ── Wrapper ───────────────────────────────────────────────────────────────────


# Config ``model_type`` strings of isotropic (single-scale) ViTs: they
# cannot feed a hierarchical decoder; mode "auto" sends them to "encoder".
ISOTROPIC_MODEL_TYPES = {
    "vit", "deit", "beit", "dinov2", "dinov2_with_registers",
    "dinov2-with-registers", "dinov3_vit", "dinov3-vit", "ijepa",
    "vitdet", "vit_det", "vit_mae", "vit_msn",
}

_VIT_FAMILY = ISOTROPIC_MODEL_TYPES


def resolve_mode(arch_cfg: Dict[str, Any], mode: str = "auto") -> str:
    """Resolve mode ``"auto"`` to ``"decoder"`` or ``"encoder"``."""
    if mode in ("decoder", "encoder"):
        return mode
    mt = (arch_cfg.get("model_type") or "").lower()
    is_isotropic = mt in ISOTROPIC_MODEL_TYPES or not arch_cfg.get(
        "stage_names", arch_cfg.get("depths"))
    return "encoder" if is_isotropic else "decoder"


def build_encoder(arch_cfg: Dict[str, Any], in_channels: int = 3) -> nn.Module:
    mt = arch_cfg.get("model_type", "convnextv2")
    if mt == "convnextv2":
        return ConvNeXtV2Encoder(
            in_channels,
            depths=tuple(arch_cfg.get("depths", (2, 2, 6, 2))),
            hidden_sizes=tuple(arch_cfg.get("hidden_sizes", (40, 80, 160, 320))))
    if mt == "resnet":
        return ResNetEncoder(
            in_channels,
            depths=tuple(arch_cfg.get("depths", (3, 4, 6, 3))),
            hidden_sizes=tuple(arch_cfg.get("hidden_sizes", (256, 512, 1024, 2048))),
            embedding_size=int(arch_cfg.get("embedding_size", 64)),
            layer_type=arch_cfg.get("layer_type", "bottleneck"),
            downsample_in_first_stage=bool(arch_cfg.get("downsample_in_first_stage", False)),
            downsample_in_bottleneck=bool(arch_cfg.get("downsample_in_bottleneck", False)))
    if mt == "swinv2":
        from sleap_nn_tpu_torch.models.transformer_encoders import build_swinv2_encoder

        return build_swinv2_encoder(arch_cfg, in_channels)
    if mt in _VIT_FAMILY:
        from sleap_nn_tpu_torch.models.transformer_encoders import build_vit_encoder

        return build_vit_encoder(arch_cfg, in_channels)
    raise ValueError(
        f"Unsupported pretrained backbone model_type {mt!r} "
        f"(supported: convnextv2, resnet, swinv2, "
        f"{', '.join(sorted(_VIT_FAMILY))}).")


def probe_pyramid(arch_cfg: Dict[str, Any], in_channels: int = 3
                  ) -> Tuple[List[int], List[int]]:
    """(strides, channels) of the encoder's feature pyramid: the encoder
    is built and run on the ``meta`` device, so no weight or FLOP is spent."""
    size = 448  # divisible by every supported patch stride (4/14/16/32)
    with torch.device("meta"):
        encoder = build_encoder(arch_cfg, in_channels).to("meta")  # numpy-made buffers too
        feats = encoder(torch.zeros(1, size, size, in_channels))
    by_stride = {size // f.shape[1]: f.shape[-1] for f in feats}
    strides = sorted(by_stride)
    return strides, [by_stride[s] for s in strides]


class _StageSubsetEncoder(nn.Module):
    """An encoder exposing only its ``out_indices`` feature stages."""

    def __init__(self, inner: nn.Module, indices: Tuple[int, ...]):
        super().__init__()
        self.inner = inner
        self.indices = tuple(indices)

    def forward(self, x):
        feats = self.inner(x)
        return [feats[i] for i in self.indices]


class PretrainedBackbone(nn.Module):
    """Pretrained encoder + probe-built SLEAP decoder (the standard output
    dict). Mode ``"encoder"`` has no decoder: the bottleneck map is
    ``middle_output`` and every head binds there."""

    def __init__(self, encoder: nn.Module, pyramid_strides: Sequence[int],
                 pyramid_channels: Sequence[int], output_stride: int = 2,
                 filters_rate: float = 2.0, convs_per_block: int = 2, kernel_size: int = 3,
                 up_interpolate: bool = True, normalize: bool = True,
                 image_mean: Sequence[float] = IMAGENET_MEAN,
                 image_std: Sequence[float] = IMAGENET_STD, mode: str = "decoder"):
        super().__init__()
        self.encoder = encoder
        self.pyramid_strides = tuple(pyramid_strides)
        self.pyramid_channels = tuple(pyramid_channels)
        self.output_stride = output_stride
        self.filters_rate = filters_rate
        self.normalize = normalize
        self.image_mean = tuple(image_mean)
        self.image_std = tuple(image_std)
        self.mode = mode
        self.dec = None
        if mode != "encoder":
            # stem_blocks=1 + down_blocks=n_skips-1 puts the no-concat
            # threshold at n_skips: blocks past the skips take no concat.
            self.dec = Decoder(
                self.pyramid_channels[-1], self.pyramid_channels[:-1][::-1],
                self.pyramid_channels[0], self._up_blocks, self._n_skips - 1, filters_rate,
                self.max_stride, stem_blocks=1, convs_per_block=convs_per_block,
                kernel_size=kernel_size, up_interpolate=up_interpolate, prefix="dec")

    @property
    def max_stride(self) -> int:
        return self.pyramid_strides[-1]

    @property
    def _n_skips(self) -> int:
        return len(self.pyramid_strides) - 1

    @property
    def _up_blocks(self) -> int:
        return int(math.log2(self.max_stride / self.output_stride))

    @property
    def stride_to_filters(self) -> Dict[int, int]:
        if self.mode == "encoder":
            return {}  # no decoder: heads bind to middle_output
        out = {self.max_stride: self.pyramid_channels[-1]}
        stride = self.max_stride
        for block in range(self._up_blocks):
            stride //= 2
            out[stride] = decoder_block_filters(
                self.pyramid_channels[0], self.filters_rate, self._n_skips - 1, 1, False,
                block)
        return out

    @property
    def middle_channels(self) -> int:
        return self.pyramid_channels[-1]

    bottleneck_channels = middle_channels

    @classmethod
    def from_config(cls, config) -> "PretrainedBackbone":
        arch_cfg, _ = resolve_hf_config(config.model_name, getattr(config, "revision", None))
        mode = resolve_mode(arch_cfg, getattr(config, "mode", "auto") or "auto")
        normalize = bool(getattr(config, "normalize", True))
        mean = tuple(config.image_mean) if config.image_mean else IMAGENET_MEAN
        std = tuple(config.image_std) if config.image_std else IMAGENET_STD
        in_channels = int(getattr(config, "in_channels", 3) or 3)
        if normalize and in_channels == 1:
            in_channels = len(mean)  # a gray input broadcasts against the mean
        strides, channels = probe_pyramid(arch_cfg, in_channels)
        if mode == "decoder" and len(strides) < 2:
            raise ValueError(
                f"Backbone {config.model_name!r} produced a single-scale "
                f"feature map (strides={strides}); it is isotropic and "
                f"cannot feed a spatial decoder. Use a hierarchical "
                f"backbone (ConvNeXtV2/ResNet/Swinv2) for spatial heads, "
                f"or mode='encoder' for a pooled head.")
        encoder = build_encoder(arch_cfg, in_channels)
        oi = getattr(config, "out_indices", None)
        if oi:
            oi = sorted(int(i) for i in oi)
            bad = [i for i in oi if not 0 <= i < len(strides)]
            if bad:
                raise ValueError(
                    f"out_indices {bad} out of range for a {len(strides)}-stage encoder.")
            strides = [strides[i] for i in oi]
            channels = [channels[i] for i in oi]
            encoder = _StageSubsetEncoder(encoder, tuple(oi))
        return cls(
            encoder=encoder, pyramid_strides=strides, pyramid_channels=channels,
            output_stride=config.output_stride, filters_rate=config.filters_rate,
            convs_per_block=config.convs_per_block, kernel_size=config.kernel_size,
            up_interpolate=config.up_interpolate, normalize=normalize, image_mean=mean,
            image_std=std, mode=mode)

    def forward(self, x: torch.Tensor) -> Dict[str, Any]:
        if self.normalize:
            mean = torch.tensor(self.image_mean, dtype=x.dtype, device=x.device)
            std = torch.tensor(self.image_std, dtype=x.dtype, device=x.device)
            x = (x - mean) / std
        feats = self.encoder(x)
        bottleneck = feats[-1]
        if self.dec is None:
            return {"outputs": [], "strides": [], "middle_output": bottleneck,
                    "intermediate_feat": bottleneck}
        result = self.dec(bottleneck, feats[:-1][::-1])
        result["middle_output"] = bottleneck
        return result


# ── Weight import ─────────────────────────────────────────────────────────────
# Each mapper turns an HF state-dict key into the flax path under the
# encoder (and, for ResNet, the flax collection), as the JAX package's
# importer does; "skip" for buffers, None for an unknown key.


def _map_convnextv2_key(key: str):
    k = key
    if k.startswith("embeddings.patch_embeddings."):
        leaf = k.rsplit(".", 1)[1]
        return (("patch_embed", "kernel") if leaf == "weight" else ("patch_embed", "bias")), (
            "conv" if leaf == "weight" else "none")
    if k.startswith("embeddings.layernorm."):
        leaf = k.rsplit(".", 1)[1]
        return ("embed_norm", "scale" if leaf == "weight" else "bias"), "none"
    m = re.match(r"encoder\.stages\.(\d+)\.downsampling_layer\.(\d)\.(weight|bias)$", k)
    if m:
        s, idx, leaf = int(m[1]), int(m[2]), m[3]
        if idx == 0:
            return (f"stage{s}_down_norm", "scale" if leaf == "weight" else "bias"), "none"
        return (f"stage{s}_down_conv", "kernel" if leaf == "weight" else "bias"), (
            "conv" if leaf == "weight" else "none")
    m = re.match(r"encoder\.stages\.(\d+)\.layers\.(\d+)\.(\w+)\.(weight|bias)$", k)
    if m:
        s, i, mod, leaf = int(m[1]), int(m[2]), m[3], m[4]
        base = (f"stage{s}_block{i}",)
        if mod == "dwconv":
            return base + ("dwconv", "kernel" if leaf == "weight" else "bias"), (
                "conv" if leaf == "weight" else "none")
        if mod == "layernorm":
            return base + ("norm", "scale" if leaf == "weight" else "bias"), "none"
        if mod in ("pwconv1", "pwconv2"):
            return base + (mod, "kernel" if leaf == "weight" else "bias"), (
                "dense" if leaf == "weight" else "none")
        if mod == "grn":
            return base + ("grn", leaf), "squeeze"
    m = re.match(r"hidden_states_norms\.stage(\d+)\.(weight|bias)$", k)
    if m:
        s, leaf = int(m[1]) - 1, m[2]
        return (f"out_norm{s}", "scale" if leaf == "weight" else "bias"), "none"
    return None


def _map_resnet_key(key: str):
    def norm_leaf(leaf):
        return {
            "weight": ("scale", "params"),
            "bias": ("bias", "params"),
            "running_mean": ("mean", "batch_stats"),
            "running_var": ("var", "batch_stats"),
        }.get(leaf)

    if key.startswith("embedder.embedder.convolution."):
        return ("stem_conv", "kernel"), "conv", "params"
    if key.startswith("embedder.embedder.normalization."):
        got = norm_leaf(key.rsplit(".", 1)[1])
        if got is None:
            return "skip"
        leaf, coll = got
        return ("stem_bn", leaf), "none", coll
    m = re.match(
        r"encoder\.stages\.(\d+)\.layers\.(\d+)\.(shortcut|layer)\.?(\d*)\."
        r"(convolution|normalization)\.(\w+)$", key)
    if m:
        s, i, kind, idx, mod, leaf = m[1], m[2], m[3], m[4], m[5], m[6]
        base = f"stage{s}_block{i}"
        if kind == "shortcut":
            sub = "shortcut_conv" if mod == "convolution" else "shortcut_bn"
        else:
            sub = f"conv{idx}" if mod == "convolution" else f"bn{idx}"
        if mod == "convolution":
            return (base, sub, "kernel"), "conv", "params"
        got = norm_leaf(leaf)
        if got is None:
            return "skip"
        nleaf, coll = got
        return (base, sub, nleaf), "none", coll
    if key.endswith("num_batches_tracked"):
        return "skip"
    return None


# flax leaf name -> torch attribute name (the rest keep their name).
_TORCH_LEAF = {"kernel": "weight", "scale": "weight", "mean": "running_mean",
               "var": "running_var"}


def _encoder_prefix(state: Mapping[str, torch.Tensor]) -> str:
    for prefix in ("backbone.encoder.inner.", "backbone.encoder."):
        if any(k.startswith(prefix) for k in state):
            return prefix
    return ""  # a bare encoder's state_dict


def load_hf_encoder_params(model_name: str, state: Mapping[str, torch.Tensor],
                           revision: Optional[str] = None):
    """Load pretrained encoder weights into a ``state_dict``, if available.

    ``state``: a ``Model``'s (or a bare encoder's) ``state_dict``. Returns
    (a new ``state_dict``, loaded). With no local snapshot it warns and
    returns ``state`` unchanged (random init). A key the mapper does not
    know, or a tensor whose target is missing or of another shape, raises
    ``ValueError``.
    """
    arch_cfg, snap = resolve_hf_config(model_name, revision=revision)
    if snap is None:
        warnings.warn(
            f"No local snapshot for pretrained backbone {model_name!r}; "
            f"training from random init. Download the checkpoint (e.g. "
            f"huggingface-cli download {model_name}) to enable transfer "
            f"learning.", stacklevel=2)
        return state, False

    tensors: Dict[str, np.ndarray] = {}
    st_files = sorted(snap.glob("*.safetensors"))
    if st_files:
        for f in st_files:
            tensors.update(read_safetensors(f))
    elif (snap / "pytorch_model.bin").exists():
        loaded = torch.load(snap / "pytorch_model.bin", map_location="cpu", weights_only=True)
        tensors = {k: v.float().numpy() for k, v in loaded.items()}
    else:
        warnings.warn(f"Snapshot {snap} has no weight files; using random init.")
        return state, False

    mt = arch_cfg.get("model_type", "convnextv2")
    if mt == "convnextv2":
        mapper = _map_convnextv2_key
    elif mt == "resnet":
        mapper = _map_resnet_key
    elif mt == "swinv2":
        from sleap_nn_tpu_torch.models.transformer_encoders import map_swinv2_key as mapper
    elif mt in _VIT_FAMILY:
        from sleap_nn_tpu_torch.models.transformer_encoders import map_vit_key as mapper
    else:
        raise ValueError(f"No weight mapper for model_type {mt!r}.")
    prefix = _encoder_prefix(state)
    out = dict(state)
    errors: List[str] = []
    n_loaded = 0
    for key, value in tensors.items():
        got = mapper(key)
        if got is None:
            errors.append(f"unmapped key {key}")
            continue
        if got == "skip":
            continue
        path, how = got[0], got[1]
        target = prefix + ".".join(path[:-1] + (_TORCH_LEAF.get(path[-1], path[-1]),))
        value = np.asarray(value)
        if how == "squeeze":
            value = value.reshape(-1)
        if target not in out:
            errors.append(f"missing leaf {target}")
            continue
        if tuple(out[target].shape) != value.shape:
            errors.append(f"shape mismatch at {target}: {value.shape} != "
                          f"{tuple(out[target].shape)}")
            continue
        out[target] = torch.from_numpy(np.array(value)).to(out[target].dtype)
        n_loaded += 1
    if errors:
        raise ValueError("pretrained weight import failed:\n  " + "\n  ".join(errors[:20]))
    return out, n_loaded > 0
