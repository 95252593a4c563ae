"""Part-affinity-field (PAF) target rendering.

Port of ``sleap_nn_tpu/ops/edge_maps.py``. PAFs are channel-last
``(..., H, W, n_edges, 2)`` or, flattened, ``(..., H, W, 2 * n_edges)``
with the interleaved ``[e0x, e0y, e1x, e1y, ...]`` channel order that the
grouping reads. The JAX package renders each sample under ``vmap``; here
the leading axes broadcast, so a whole batch renders in one expression.
The JAX package renders PAFs with jnp, so this module is plain PyTorch.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from sleap_nn_tpu_torch.ops.grid import make_grid_vectors


def distance_to_edge(
    points: torch.Tensor, edge_source: torch.Tensor, edge_destination: torch.Tensor
) -> torch.Tensor:
    """Squared distance from query points to line segments.

    Args:
        points: ``(..., 2)`` query points.
        edge_source / edge_destination: ``(n_edges, 2)`` segment ends, or any
            shape that broadcasts against ``points[..., None, :]``.

    Returns:
        ``(..., n_edges)`` squared distances to the segments: the projection
        parameter is clamped to [0, 1], and the squared length to at least 1.
    """
    direction = edge_destination - edge_source
    edge_length = torch.clamp((direction**2).sum(dim=-1), min=1.0)
    rel = points[..., None, :] - edge_source
    t = torch.clamp((rel * direction).sum(dim=-1) / edge_length, 0.0, 1.0)
    return ((t[..., None] * direction - rel) ** 2).sum(dim=-1)


def _grid(xv: torch.Tensor, yv: torch.Tensor) -> torch.Tensor:
    """``(H, W, 2)`` (x, y) of every grid cell (``jnp.meshgrid``'s xy order)."""
    return torch.stack([xv[None, :].expand(len(yv), -1), yv[:, None].expand(-1, len(xv))], dim=-1)


def _gaussian(d: torch.Tensor, sigma: float) -> torch.Tensor:
    """``exp(-d^2 / f32(2 sigma^2))`` with an IEEE division: the divisor is a
    0-dim tensor on ``d``'s device, since ATen's CUDA division turns a
    Python scalar divisor into a multiplication by its reciprocal."""
    return torch.exp(-(d**2) / d.new_full((), 2 * sigma**2))


def make_edge_maps(
    xv: torch.Tensor,
    yv: torch.Tensor,
    edge_source: torch.Tensor,
    edge_destination: torch.Tensor,
    sigma: float,
) -> torch.Tensor:
    """Gaussian tube around each edge: ``(..., H, W, n_edges)`` for edge
    ends of shape ``(..., n_edges, 2)``.

    The Gaussian takes the squared distance as its argument, as the JAX
    package's ``gaussian_pdf(distance_to_edge(...))`` does.
    """
    src = edge_source[..., None, None, :, :]  # (..., 1, 1, E, 2)
    dst = edge_destination[..., None, None, :, :]
    return _gaussian(distance_to_edge(_grid(xv, yv), src, dst), sigma)


def make_pafs(
    xv: torch.Tensor,
    yv: torch.Tensor,
    edge_source: torch.Tensor,
    edge_destination: torch.Tensor,
    sigma: float,
) -> torch.Tensor:
    """PAFs of one edge set: unit edge vectors masked by the edge tube.

    Returns ``(..., H, W, n_edges, 2)``; NaN where an edge end is missing
    or the edge has zero length (callers zero-fill before the sum).
    """
    direction = edge_destination - edge_source
    unit = direction / torch.sqrt((direction**2).sum(dim=-1, keepdim=True))
    tube = make_edge_maps(xv, yv, edge_source, edge_destination, sigma)
    return tube[..., None] * unit[..., None, None, :, :]


def make_multi_pafs(
    xv: torch.Tensor,
    yv: torch.Tensor,
    edge_sources: torch.Tensor,
    edge_destinations: torch.Tensor,
    sigma: float,
) -> torch.Tensor:
    """Multi-instance PAFs summed over instances (NaN terms contribute 0).

    Args:
        edge_sources / edge_destinations: ``(..., n_instances, n_edges, 2)``.

    Returns:
        ``(..., H, W, n_edges, 2)``.
    """
    *lead, n_inst, n_edges, _ = edge_sources.shape
    pafs = make_pafs(xv, yv, edge_sources.reshape(*lead, n_inst * n_edges, 2),
                     edge_destinations.reshape(*lead, n_inst * n_edges, 2), sigma)
    pafs = pafs.reshape(*lead, len(yv), len(xv), n_inst, n_edges, 2)
    return torch.nan_to_num(pafs).sum(dim=-3)


def get_edge_points(
    instances: torch.Tensor, edge_inds: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge (source, destination) points: ``instances`` ``(..., n_nodes,
    2)`` and ``edge_inds`` ``(n_edges, 2)`` -> two ``(..., n_edges, 2)``."""
    edge_inds = edge_inds.to(device=instances.device, dtype=torch.long)
    return (instances.index_select(-2, edge_inds[:, 0]),
            instances.index_select(-2, edge_inds[:, 1]))


def generate_pafs(
    instances: torch.Tensor,
    img_hw: Tuple[int, int],
    edge_inds: Union[torch.Tensor, Sequence[Tuple[int, int]]],
    sigma: float = 1.5,
    output_stride: int = 2,
    flatten_channels: bool = True,
) -> torch.Tensor:
    """Render PAF training targets.

    Args:
        instances: ``(..., n_instances, n_nodes, 2)`` padded with NaN rows;
            the leading axes (a batch) render together.
        img_hw: input image size; the grid is ``img_hw // output_stride``.
        edge_inds: ``(n_edges, 2)`` (source, destination) node indices.
        sigma: tube width in input pixels (scaled by the stride here).
        flatten_channels: return ``(..., H, W, 2 * n_edges)`` in
            ``[e0x, e0y, e1x, e1y, ...]`` order, else ``(..., H, W, n_edges, 2)``.

    An instance renders only if one of its nodes lies strictly inside
    ``(0, xv[-1]) x (0, yv[-1])``; the others render zeros.
    """
    height, width = img_hw
    xv, yv = make_grid_vectors(height, width, output_stride, device=instances.device)
    limit = torch.stack([xv[-1], yv[-1]])
    in_img = (instances > 0) & (instances < limit)
    keep = in_img.all(dim=-1).any(dim=-1)  # (..., n_instances)
    inst = torch.where(keep[..., None, None], instances, float("nan"))
    edge_inds = torch.as_tensor(edge_inds, dtype=torch.long).reshape(-1, 2)
    src, dst = get_edge_points(inst, edge_inds)
    pafs = make_multi_pafs(xv, yv, src, dst, sigma * output_stride)
    if flatten_channels:
        pafs = pafs.flatten(-2)
    return pafs
