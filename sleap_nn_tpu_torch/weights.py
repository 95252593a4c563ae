"""Weight bridge: JAX package (flax) params -> the port's ``state_dict``.

The inverse of the JAX package's torch-checkpoint importer
(``sleap_nn_tpu/torch_models.py``): every key of the port model's
``state_dict()`` names a reference block (``stack0_enc0_conv0``,
``stack0_dec0_s32_to_s16_refine_conv0``, ``head_layers.0.<Head>.0``, ...),
which maps to one flax leaf; the leaf is transposed back to torch layout:

- conv kernels: flax HWIO -> torch OIHW;
- transposed-conv kernels: flax (kh, kw, in, out), spatially flipped ->
  torch (in, out, kh, kw);
- dense kernels (the class-vectors head: ``pre_classification{j}_fc`` <->
  ``ClassVectorsHead/fc{j}``, ``ClassVectorsHead`` <->
  ``ClassVectorsHead/logits``): flax (in, out) -> torch (out, in);
- biases as they are.

The key -> flax path rules are this module's own copy of the importer's.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Tuple

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


def flax_path_for(torch_key: str) -> Tuple[Tuple[str, ...], str]:
    """Map one ``state_dict`` key to (flax tree path, leaf kind).

    Leaf kind is ``conv_kernel``, ``trans_conv_kernel``, ``dense_kernel``
    or ``bias``.
    """
    parts = torch_key.split(".")
    if parts[0] == "model":
        parts = parts[1:]
    leaf = parts[-1]
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
    if kind == "bias":
        return value
    if kind == "conv_kernel":
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if kind == "trans_conv_kernel":
        return value[::-1, ::-1].transpose(2, 3, 0, 1)  # un-flip, -> (in, out, kh, kw)
    if kind == "dense_kernel":
        return value.T  # (in, out) -> (out, in)
    raise KeyError(kind)


def _walk(node: Mapping, prefix=()):
    for name, child in node.items():
        if isinstance(child, Mapping):
            yield from _walk(child, prefix + (name,))
        else:
            yield prefix + (name,), child


def flax_to_torch_state(params: Mapping[str, Any], model: nn.Module) -> Dict[str, torch.Tensor]:
    """Build ``model``'s ``state_dict`` from a flax param tree.

    ``params``: the flax tree of the JAX package's ``Model`` (with or
    without the top ``"params"`` level), nested dicts of arrays. Raises
    ValueError listing missing, unused or mis-shaped leaves.
    """
    tree = params.get("params", params)
    leaves = {path: np.asarray(v) for path, v in _walk(tree)}
    template = model.state_dict()
    out, used, errors = {}, set(), []
    for key, ref in template.items():
        try:
            path, kind = flax_path_for(key)
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
