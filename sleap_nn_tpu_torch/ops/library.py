"""Kernels 1, 2 and 3 as registered PyTorch operators, for ``torch.export``.

``torch.export`` traces with fake tensors, which have no data pointer, so
it cannot trace through a wrapper that launches a kernel through
``ctypes``. Each kernel therefore also stands as a ``torch.library``
operator in the ``sleap_nn_tpu_torch`` namespace, with a fake (shape)
function for tracing:

- ``fused_double_conv3x3(x, w1, b1, w2, b2, activation)`` (kernel 1);
- ``nms_scores(cms, threshold, kernel)`` (kernel 2);
- ``paf_line_scores(pafs, grouped_peaks, grouped_mask, edge_inds, t,
  pafs_stride, max_edge_length, dist_penalty_weight)`` (kernel 3).

Each operator's implementation is its wrapper's body: on a CPU tensor
the plain PyTorch version, on a CUDA tensor the kernel (which raises on a
failed build or launch; nothing falls back). The wrappers call their
operator only while ``torch.export`` traces (:func:`tracing_active`); the
live predict path calls the wrappers' bodies directly and so pays no
dispatcher time. A loaded ``.pt2`` program calls the operators, so this
module must be imported before one is loaded
(``sleap_nn_tpu_torch.export`` does).
"""

from __future__ import annotations

from typing import Optional

import torch

NAMESPACE = "sleap_nn_tpu_torch"


def tracing_active() -> bool:
    """Whether the wrappers route through the registered operators: while
    ``torch.export`` traces."""
    return torch.compiler.is_exporting()


@torch.library.custom_op(f"{NAMESPACE}::fused_double_conv3x3", mutates_args=())
def fused_double_conv3x3_op(x: torch.Tensor, w1: torch.Tensor, b1: Optional[torch.Tensor],
                            w2: torch.Tensor, b2: Optional[torch.Tensor],
                            activation: str) -> torch.Tensor:
    from sleap_nn_tpu_torch.ops.fused_conv import _fused_double_conv3x3

    return _fused_double_conv3x3(x.contiguous(), w1, b1, w2, b2, activation)


@fused_double_conv3x3_op.register_fake
def _(x, w1, b1, w2, b2, activation):
    return x.new_empty((x.shape[0], x.shape[1], x.shape[2], w2.shape[3]))


@torch.library.custom_op(f"{NAMESPACE}::nms_scores", mutates_args=())
def nms_scores_op(cms: torch.Tensor, threshold: float, kernel: int) -> torch.Tensor:
    from sleap_nn_tpu_torch.ops.kernels import _nms_scores

    return _nms_scores(cms.contiguous(), threshold, kernel)


@nms_scores_op.register_fake
def _(cms, threshold, kernel):
    return cms.new_empty(cms.shape, dtype=torch.float32)


@torch.library.custom_op(f"{NAMESPACE}::paf_line_scores", mutates_args=())
def paf_line_scores_op(pafs: torch.Tensor, grouped_peaks: torch.Tensor,
                       grouped_mask: torch.Tensor, edge_inds: torch.Tensor, t: torch.Tensor,
                       pafs_stride: float, max_edge_length: float,
                       dist_penalty_weight: float) -> torch.Tensor:
    from sleap_nn_tpu_torch.inference.paf_grouping import _dense
    from sleap_nn_tpu_torch.ops.kernels import paf_line_scores

    return paf_line_scores(_dense(pafs, 2 * pafs.element_size()), _dense(grouped_peaks, 8),
                           _dense(grouped_mask), _dense(edge_inds), _dense(t),
                           pafs_stride, max_edge_length, dist_penalty_weight)


@paf_line_scores_op.register_fake
def _(pafs, grouped_peaks, grouped_mask, edge_inds, t, pafs_stride, max_edge_length,
      dist_penalty_weight):
    b, _, k, _ = grouped_peaks.shape
    return grouped_peaks.new_empty((b, edge_inds.shape[0], k, k))


OPS = {
    "fused_double_conv3x3": torch.ops.sleap_nn_tpu_torch.fused_double_conv3x3,
    "nms_scores": torch.ops.sleap_nn_tpu_torch.nms_scores,
    "paf_line_scores": torch.ops.sleap_nn_tpu_torch.paf_line_scores,
}
