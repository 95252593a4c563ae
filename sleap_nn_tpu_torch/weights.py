"""Weight bridge: JAX package (flax) params -> the port's ``state_dict``.

The inverse of the JAX package's torch-checkpoint importer
(``sleap_nn_tpu/torch_models.py``) for the UNet: every key of the port
model's ``state_dict()`` names a reference block (``stack0_enc0_conv0``,
``stack0_dec0_s32_to_s16_refine_conv0``, ``head_layers.0.<Head>.0``, ...),
which maps to one flax leaf. The key -> flax path rules of these keys are
this module's own copy of the importer's.

The ConvNeXt, SwinT and pretrained backbones have no reference torch keys
to follow: their modules are named after the flax tree, so a key is its
flax path, once the port's containers are taken out (a ``decoder_stack.N``
and a conv block's ``blocks`` dict, whose entry ``dec0_s32_to_s16_refine_conv0``
or ``middle_expand_conv0`` is the flax ``dec0_s32_to_s16/refine_conv0`` or
``middle_expand/conv0``). The module that holds a leaf names it:

- ``Conv2d`` (depthwise too) ``weight``: flax ``kernel``, HWIO -> OIHW
  (a depthwise ``(kh, kw, 1, C)`` -> ``(C, 1, kh, kw)``);
- ``ConvTranspose2d`` ``weight``: flax ``kernel`` (kh, kw, in, out),
  spatially flipped -> torch (in, out, kh, kw);
- ``Linear`` ``weight``: flax ``kernel``, (in, out) -> (out, in);
- ``LayerNorm`` ``weight``: flax ``scale``;
- ``FrozenBatchNorm`` ``weight`` / ``bias``: the ``params`` ``scale`` /
  ``bias``; ``running_mean`` / ``running_var``: the ``batch_stats``
  ``mean`` / ``var``;
- any other leaf (biases, layer-scale and GRN gammas, relative-position
  tables, Swinv2's ``logit_scale``, ViT tokens and position embeddings)
  keeps its name and layout.

The class-vectors head's dense layers (``pre_classification{j}_fc`` <->
``ClassVectorsHead/fc{j}``, ``ClassVectorsHead`` <->
``ClassVectorsHead/logits``) are flax (in, out) -> torch (out, in).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

_BACKBONE_PATTERNS = (
    (re.compile(r"^stack(\d+)_enc(\d+)_conv(\d+)$"),
     lambda m: ("backbone", f"stack{m[1]}_enc", f"enc{m[2]}", f"conv{m[3]}")),
    (re.compile(r"^stack(\d+)_enc\d+_middle_(expand|contract)_conv(\d+)$"),
     lambda m: ("backbone", f"stack{m[1]}_middle_{m[2]}", f"conv{m[3]}")),
    (re.compile(r"^stack(\d+)_dec(\d+)_(s\d+_to_s\d+)_trans_conv$"),
     lambda m: ("backbone", f"stack{m[1]}_dec", f"dec{m[2]}_{m[3]}", "trans_conv")),
    (re.compile(r"^stack(\d+)_dec(\d+)_(s\d+_to_s\d+)_refine_conv(\d+)$"),
     lambda m: ("backbone", f"stack{m[1]}_dec", f"dec{m[2]}_{m[3]}", f"refine_conv{m[4]}")),
    (re.compile(r"^stem(\d+)_conv(\d+)$"),
     lambda m: ("backbone", "stem", f"stem{m[1]}", f"conv{m[2]}")),
)


_UNET_PARTS = ("encoders", "middle_blocks", "decoders", "stem")
_DEC_BLOCK = re.compile(r"^(dec\d+_s\d+_to_s\d+)_(.+)$")


def _flax_named_path(parts) -> Tuple[str, ...]:
    """The flax path of a flax-named module path (see the module doc)."""
    out = []
    i = 0
    while i < len(parts):
        part = parts[i]
        if part == "decoder_stack":
            i += 2  # the container and its index
            continue
        if part == "blocks":
            name = parts[i + 1]
            m = _DEC_BLOCK.match(name)
            if m:
                out += [m[1], m[2]]
            elif out and name.startswith(out[-1] + "_"):
                out.append(name[len(out[-1]) + 1:])
            else:
                out.append(name)
            i += 2
            continue
        out.append(part)
        i += 1
    return tuple(out)


def _leaf_of(module: Optional[nn.Module], leaf: str, torch_key: str) -> Tuple[str, str, str]:
    """(flax collection, flax leaf name, kind) of the parameter or buffer
    ``leaf`` of ``module``."""
    from sleap_nn_tpu_torch.models.pretrained import FrozenBatchNorm

    if isinstance(module, FrozenBatchNorm):
        return {"weight": ("params", "scale", "value"), "bias": ("params", "bias", "bias"),
                "running_mean": ("batch_stats", "mean", "value"),
                "running_var": ("batch_stats", "var", "value")}[leaf]
    if leaf == "weight":
        if isinstance(module, nn.ConvTranspose2d):
            return "params", "kernel", "trans_conv_kernel"
        if isinstance(module, nn.Conv2d):
            return "params", "kernel", "conv_kernel"
        if isinstance(module, nn.Linear):
            return "params", "kernel", "dense_kernel"
        if isinstance(module, nn.LayerNorm):
            return "params", "scale", "value"
        if module is None:
            raise KeyError(f"{torch_key!r}: the leaf kind needs its module")
    return "params", leaf, "bias" if leaf == "bias" else "value"


def flax_path_for(torch_key: str, module: Optional[nn.Module] = None
                  ) -> Tuple[Tuple[str, ...], str]:
    """Map one ``state_dict`` key to (flax tree path, leaf kind).

    Leaf kind is ``conv_kernel``, ``trans_conv_kernel``, ``dense_kernel``,
    ``bias`` or ``value`` (kept as it is). A BatchNorm running statistic's
    path starts with ``"batch_stats"`` (its collection). ``module``: the
    module holding the leaf; a flax-named ``weight`` needs it.
    """
    parts = torch_key.split(".")
    if parts[0] == "model":
        parts = parts[1:]
    leaf = parts[-1]
    if parts[0] == "backbone" and len(parts) > 2 and parts[1] not in _UNET_PARTS:
        coll, name, kind = _leaf_of(module, leaf, torch_key)
        path = _flax_named_path(parts[:-1]) + (name,)
        return (path if coll == "params" else (coll,) + path), kind
    if leaf not in ("weight", "bias"):
        raise KeyError(f"unsupported leaf {leaf!r} in {torch_key!r}")
    if parts[0] == "backbone":
        for pattern, build in _BACKBONE_PATTERNS:
            m = pattern.match(parts[-2])
            if m:
                path = build(m)
                if leaf == "bias":
                    return path + ("bias",), "bias"
                kind = "trans_conv_kernel" if path[-1] == "trans_conv" else "conv_kernel"
                return path + ("kernel",), kind
        raise KeyError(f"unrecognized backbone block {parts[-2]!r} in {torch_key!r}")
    if parts[0] == "head_layers":
        name = parts[2]
        fc = re.match(r"^pre_classification(\d+)_fc$", name)
        if fc or (name == "ClassVectorsHead" and len(parts) == 4):
            path = ("ClassVectorsHead", f"fc{fc.group(1)}" if fc else "logits")
            if leaf == "bias":
                return path + ("bias",), "bias"
            return path + ("kernel",), "dense_kernel"
        path = (name, "head_conv")
        if leaf == "bias":
            return path + ("bias",), "bias"
        return path + ("kernel",), "conv_kernel"
    raise KeyError(f"unrecognized key {torch_key!r}")


def _to_torch_layout(value: np.ndarray, kind: str) -> np.ndarray:
    if kind in ("bias", "value"):
        return value
    if kind == "conv_kernel":
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if kind == "trans_conv_kernel":
        return value[::-1, ::-1].transpose(2, 3, 0, 1)  # un-flip, -> (in, out, kh, kw)
    if kind == "dense_kernel":
        return value.T  # (in, out) -> (out, in)
    raise KeyError(kind)


def torch_key_paths(model: nn.Module) -> Dict[str, Tuple[Tuple[str, ...], str]]:
    """``{state_dict key: (flax path, leaf kind)}`` of every key of ``model``."""
    modules = dict(model.named_modules())
    return {key: flax_path_for(key, modules.get(key.rsplit(".", 1)[0]))
            for key in model.state_dict()}


def _walk(node: Mapping, prefix=()):
    for name, child in node.items():
        if isinstance(child, Mapping):
            yield from _walk(child, prefix + (name,))
        else:
            yield prefix + (name,), child


def flax_to_torch_state(params: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """Build ``model``'s ``state_dict`` from a flax param tree.

    ``params``: the flax variables of the JAX package's ``Model`` (a
    ``"params"`` collection and any other, such as ``"batch_stats"``), or
    its bare params tree; nested dicts of arrays. Raises
    ValueError listing missing, unused or mis-shaped leaves.
    """
    if "params" in params:
        leaves = {path: np.asarray(v) for path, v in _walk(params["params"])}
        for coll, sub in params.items():
            if coll != "params":
                leaves.update({(coll,) + path: np.asarray(v) for path, v in _walk(sub)})
    else:
        leaves = {path: np.asarray(v) for path, v in _walk(params)}
    template = model.state_dict()
    modules = dict(model.named_modules())
    out, used, errors = {}, set(), []
    for key, ref in template.items():
        try:
            path, kind = flax_path_for(key, modules.get(key.rsplit(".", 1)[0]))
        except KeyError as exc:
            errors.append(str(exc))
            continue
        if path not in leaves:
            errors.append(f"{key}: no flax leaf {'/'.join(path)}")
            continue
        used.add(path)
        value = np.array(_to_torch_layout(leaves[path], kind), dtype=np.float32)  # own copy
        if tuple(value.shape) != tuple(ref.shape):
            errors.append(f"{key}: shape {value.shape} != expected {tuple(ref.shape)}")
            continue
        out[key] = torch.from_numpy(value)
    unused = sorted("/".join(p) for p in set(leaves) - used)
    if unused:
        errors.append(f"unused flax leaves: {unused}")
    if errors:
        raise ValueError("flax -> torch weight conversion failed:\n  " + "\n  ".join(errors))
    return out


# ── SAM: the JAX package's flat params -> the port's SamModel state_dict ─────

# The JAX importer's layout rules (``sleap_nn_tpu/models/sam_jax.py``'s
# ``convert_sam_state_dict``), copied here and run backwards.
_SAM_CONV_SUFFIXES = (
    "patch_embed.projection.weight",
    "neck.conv1.weight",
    "neck.conv2.weight",
    "mask_embed.conv1.weight",
    "mask_embed.conv2.weight",
    "mask_embed.conv3.weight",
)
_SAM_CONVT_SUFFIXES = ("upscale_conv1.weight", "upscale_conv2.weight")
_SAM_DIRECT_2D_MARKERS = (
    "rel_pos_h",
    "rel_pos_w",
    "positional_embedding",
    "iou_token.weight",
    "mask_tokens.weight",
    "not_a_point_embed.weight",
    "no_mask_embed.weight",
)


def sam_params_to_torch(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The JAX package's flat SAM params (arrays keyed by the upstream
    names, NHWC layouts) -> the port's ``SamModel`` state dict: conv
    kernels HWIO -> OIHW, linear kernels (in, out) -> (out, in); the
    transposed-conv weights, embeddings, norms and relative-position tables
    as they are. The inverse of the JAX ``convert_sam_state_dict``."""
    out = {}
    for key, value in params.items():
        arr = np.asarray(value, dtype=np.float32)
        if any(key.endswith(s) for s in _SAM_CONV_SUFFIXES):
            arr = arr.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        elif any(key.endswith(s) for s in _SAM_CONVT_SUFFIXES):
            pass  # (in, out, kh, kw) in both
        elif "point_embed" in key and key.endswith(".weight"):
            pass  # nn.Embedding rows
        elif arr.ndim == 2 and key.endswith(".weight") and not any(
                m in key for m in _SAM_DIRECT_2D_MARKERS):
            arr = arr.T  # nn.Linear
        out[key] = torch.from_numpy(np.array(arr))  # own, contiguous copy
    return out
