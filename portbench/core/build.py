"""The systems under test, built from a configuration file and a seed.

Frozen from the repository's chip smoke (its ``build_models``,
``random_init`` and ``build_layer``), so that a later change to that
script cannot move the benchmark. The weights are the benchmark's own
inputs: drawn on the device from the seed in one call a model, He-normal
for the backbone's convs with zero biases, and for the 1x1 heads a gain
of 0.1 with a 0.5 bias, so that the maps vary by about 0.1 around 0.5 (a
flat map would round to one bf16 value and hold no strict maximum). The
frames are uint8 noise drawn on the device.
"""

from __future__ import annotations

from types import SimpleNamespace as ns
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn


def sub_seed(seed: int, tag: int) -> int:
    """A 63-bit seed of its own for each use (``tag``) of a run's seed."""
    state = np.random.SeedSequence([seed & (2**64 - 1), tag]).generate_state(2, np.uint32)
    return int(state[0]) << 31 ^ int(state[1])


def frame_pool(seed: int, shape, device) -> np.ndarray:
    """``shape`` (n, H, W, C) uint8 noise frames, drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    frames = torch.randint(0, 256, tuple(shape), generator=gen, device=device, dtype=torch.uint8)
    return frames.cpu().numpy()


def unet_config(cfg: Dict):
    from sleap_nn_tpu_torch.config.model_config import UNetConfig

    return UNetConfig(**cfg["backbone"]["unet"])


def node_names(cfg: Dict):
    return [f"n{i}" for i in range(cfg["n_nodes"])]


def random_init(gen: torch.Generator, *models: nn.Module) -> None:
    """He-normal backbone convs with zero biases; 1x1 heads of gain 0.1,
    bias 0.5; one normal draw for all the weights of ``models``."""
    convs, heads = [], []
    for m in models:
        convs += [c for c in m.backbone.modules() if isinstance(c, (nn.Conv2d, nn.ConvTranspose2d))]
        heads += [head[0] for layer in m.head_layers for head in layer.values()]
    sizes = [c.weight.numel() for c in convs + heads]
    dev = convs[0].weight.device
    z = torch.randn(sum(sizes), generator=gen, device=dev).split(sizes)
    with torch.no_grad():
        for c, zi in zip(convs, z):
            fan_in = c.weight[0].numel()
            c.weight.copy_(zi.view_as(c.weight) * (2.0 / fan_in) ** 0.5)
            c.bias.zero_()
        for h, zi in zip(heads, z[len(convs):]):
            h.weight.copy_(zi.view_as(h.weight) * 0.1 * h.in_channels ** -0.5)
            h.bias.fill_(0.5)


def topdown_models(cfg: Dict, seed: int, device) -> Tuple[nn.Module, nn.Module]:
    """The centroid and centered-instance models, float32, on ``device``."""
    from sleap_nn_tpu_torch.models.model import Model

    ucfg = unet_config(cfg)
    c, i = cfg["centroid"]["confmaps"], cfg["centered_instance"]["confmaps"]
    with torch.device(device):
        centroid = Model.from_config("unet", ucfg, ns(confmaps=ns(
            anchor_part=c.get("anchor_part"), sigma=c["sigma"], output_stride=c["output_stride"],
            loss_weight=None)), "centroid")
        instance = Model.from_config("unet", ucfg, ns(confmaps=ns(
            part_names=node_names(cfg), anchor_part=i.get("anchor_part"), sigma=i["sigma"],
            output_stride=i["output_stride"], loss_weight=None)), "centered_instance")
    random_init(torch.Generator(device=device).manual_seed(sub_seed(seed, 2)), centroid, instance)
    return centroid.eval(), instance.eval()


def topdown_layer(cfg: Dict, centroid, instance, device, use_bf16: bool):
    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.inference.layers import (
        CenteredInstanceLayer, CentroidLayer, PostprocessConfig, PreprocessConfig, TopDownLayer)

    pre = PreprocessConfig(ensure_grayscale=True, max_stride=cfg["backbone"]["unet"]["max_stride"])
    kw = dict(use_bf16=use_bf16, output_dtype=None, device=device)
    post = dict(peak_threshold=cfg["peak_threshold"], refinement=cfg["refinement"],
                integral_patch_size=cfg["integral_patch_size"])
    c_layer = CentroidLayer(TorchBackend(centroid, None, **kw), pre,
                            PostprocessConfig(max_instances=cfg["max_instances"], **post),
                            output_stride=cfg["centroid"]["confmaps"]["output_stride"],
                            device=device)
    i_layer = CenteredInstanceLayer(TorchBackend(instance, None, **kw), pre, PostprocessConfig(**post),
                                    output_stride=cfg["centered_instance"]["confmaps"]["output_stride"],
                                    device=device)
    return TopDownLayer(c_layer, i_layer, max_instances=cfg["max_instances"],
                        crop_size=cfg["crop_size"], device=device)


def weights(model: nn.Module) -> Dict[str, torch.Tensor]:
    """The model's float32 weights as the reference takes them (detached copies)."""
    return {k: v.detach().float().clone() for k, v in model.state_dict().items()}
