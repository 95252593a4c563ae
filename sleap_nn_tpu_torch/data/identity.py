"""Identity-model training targets: class vectors and class maps.

Port of ``sleap_nn_tpu/data/identity.py``, in plain torch ops (the JAX
package computes them in jnp, outside any Pallas kernel). The class maps
start from per-instance confidence maps (``ops/kernels.make_confmaps``),
not kernel 4's max over instances: each class keeps its own instances.
"""

from __future__ import annotations

import torch

from sleap_nn_tpu_torch.ops.confmaps import make_confmaps
from sleap_nn_tpu_torch.ops.grid import make_grid_vectors


def make_class_vectors(class_inds: torch.Tensor, n_classes: int) -> torch.Tensor:
    """One-hot class vectors ``(..., n_classes)`` f32; a negative index
    (untracked or padding) gives all zeros."""
    onehot = torch.nn.functional.one_hot(class_inds.long().clamp(min=0), n_classes)
    return torch.where((class_inds >= 0)[..., None], onehot.to(torch.float32), 0.0)


def make_class_maps(
    confmaps: torch.Tensor,
    class_inds: torch.Tensor,
    n_classes: int,
    threshold: float = 0.2,
) -> torch.Tensor:
    """Class maps from per-instance confmaps.

    Args:
        confmaps: ``(B, n_instances, H, W, n_nodes)``.
        class_inds: ``(B, n_instances)`` (-1 = untracked or padding).

    Returns:
        ``(B, H, W, n_classes)``: for each class, the max over its instances
        of the instance's support (its max over nodes) above ``threshold``,
        rescaled to [0, 1].
    """
    support = confmaps.amax(dim=-1)  # (B, I, H, W)
    gated = torch.clamp((support - threshold) / (1 - threshold), 0.0, 1.0)
    gated = torch.where(support > threshold, 1.0, 0.0) * gated
    onehot = make_class_vectors(class_inds, n_classes)  # (B, I, n_classes)
    return (gated[..., None] * onehot[:, :, None, None, :]).amax(dim=1)


def generate_class_maps(
    instances: torch.Tensor,
    img_hw,
    class_inds: torch.Tensor,
    n_classes: int,
    sigma: float = 5.0,
    output_stride: int = 2,
    threshold: float = 0.2,
) -> torch.Tensor:
    """Class maps ``(B, H/s, W/s, n_classes)`` rendered from keypoints
    ``(B, I, N, 2)``; ``sigma`` in input pixels."""
    height, width = img_hw
    xv, yv = make_grid_vectors(height, width, output_stride, device=instances.device)
    cms = make_confmaps(instances, xv, yv, sigma * output_stride)  # (B, I, Hs, Ws, N)
    return make_class_maps(cms, class_inds, n_classes, threshold)
