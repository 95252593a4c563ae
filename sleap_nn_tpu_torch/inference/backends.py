"""Model backend for inference.

Port of ``sleap_nn_tpu/inference/backends.py`` (``JaxBackend``):
``TorchBackend`` runs a model's forward on one device, optionally in
bfloat16. PyTorch runs eagerly, so there is no jit; the weights are cast
and moved once at construction instead of on every call.
"""

from __future__ import annotations

import copy
from typing import Dict, Mapping, Optional

import torch
from torch import nn


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; a CUDA request without a card raises.

    There is no silent CPU fallback: CPU runs ask for ``device="cpu"``;
    ``"auto"`` and None mean the card, as the command line's ``--device``.
    """
    device = torch.device("cuda" if device in (None, "auto") else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is False; "
                "pass device='cpu' to run on the CPU")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def maybe_fuse_convs(model: nn.Module, fused: bool) -> nn.Module:
    """Route every eligible double-conv block through the fused kernel (or not)."""
    for module in model.modules():
        if hasattr(module, "use_fused"):
            module.use_fused = fused
    return model


class TorchBackend:
    """Forward pass of one model on one device.

    Args:
        model: a port ``Model``; the backend keeps its own copy.
        params: a ``state_dict`` to load (strictly) into the copy, or None
            to keep the model's weights.
        use_bf16: run in bfloat16: input and weights are cast to bf16.
        fused_convs: evaluate double-conv blocks with the fused kernel.
            None means on for a CUDA device (the kernel's place) and off on
            the CPU; False is the explicit opt-out.
        output_dtype: dtype of the returned maps; None keeps the compute
            dtype (bf16 maps under ``use_bf16``).
        device: ``"cuda"`` (default) or ``"cpu"``.
    """

    def __init__(self, model: nn.Module, params: Optional[Mapping] = None,
                 use_bf16: bool = False, fused_convs: Optional[bool] = None,
                 output_dtype: Optional[torch.dtype] = torch.float32, device="cuda"):
        self.device = resolve_device(device)
        model = copy.deepcopy(model)
        if params is not None:
            model.load_state_dict(params, strict=True)
        if fused_convs is None:
            fused_convs = self.device.type == "cuda"
        maybe_fuse_convs(model, bool(fused_convs))
        dtype = torch.bfloat16 if use_bf16 else torch.float32
        self.model = model.to(device=self.device, dtype=dtype).eval()
        self.use_bf16 = use_bf16
        self.output_dtype = output_dtype

    @torch.inference_mode()
    def __call__(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        x = x.to(self.device)
        if self.use_bf16:
            x = x.to(torch.bfloat16)
        out = self.model(x)
        if self.output_dtype is None:
            return out
        return {k: v.to(self.output_dtype) for k, v in out.items()}
