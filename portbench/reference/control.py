"""The control: the plain reference put in the program's place, its convs
computed in fp8 (e4m3, one scale a tensor, float32 accumulation), the
precision next below the bf16 that the predict configurations state; its
maps are rounded to bf16, as the program's are.

``control_layer`` builds it for a predict entry (``entries/predict.py``'s
``make_layer``) from the same seed, so that the control serves the same
frames on the same weights; the judge then has to find it not correct.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.core import build
from portbench.reference import topdown

FP8_MAX = 448.0  # the largest finite float8_e4m3fn


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to fp8 e4m3 under one scale for the tensor."""
    scale = t.abs().amax().clamp(min=1e-12) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_conv(x, w, b, pad):
    return F.conv2d(fp8(x), fp8(w), b, padding=pad)


class Control:
    """A layer for the predictor whose answers are the reference's, in fp8."""

    def __init__(self, predict, device):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device, self._predict = device, predict

    def predict_async(self, images):
        with torch.no_grad():
            return self._predict(images.to(self.device))

    def postprocess_host(self, host):
        return host


def control_layer(ctx):
    """``(control layer, reference weights)`` for a predict entry's ``make_layer``."""
    cfg = ctx.config
    centroid, instance = build.topdown_models(cfg, ctx.seed, ctx.device)
    states = {"centroid": build.weights(centroid), "instance": build.weights(instance)}
    spec = topdown.TopDownSpec.of(cfg, ctx.traffic["precision"])
    return Control(lambda f: topdown.predict(states["centroid"], states["instance"], f, spec,
                                             fp8_conv), ctx.device), states
