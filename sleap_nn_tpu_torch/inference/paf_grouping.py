"""PAF line-integral scoring (device) + instance grouping (host).

Port of ``sleap_nn_tpu/inference/paf_grouping.py``:

- Device half: peaks are grouped into a fixed-size per-node layout
  ``(B, n_nodes, K, 2)`` with a validity mask, and every src x dst pair of
  every edge is scored at once, ``(B, n_edges, K, K)``. The scoring runs in
  the ``paf_line_scores`` kernel (``ops/kernels.py``) on a CUDA tensor.
- Host half: per-edge Hungarian matching (scipy) and the greedy union of
  matches into instances, on the fetched numpy arrays. This is the JAX
  package's scipy path; its C++ copy of the same grouping
  (``sleap_nn_tpu/native/paf_group.cpp``) is not ported.

The edge order comes from this module's own breadth-first walk, which
gives networkx's order (the JAX package calls networkx, which the GPU
machine does not have).
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment

from sleap_nn_tpu_torch.ops.kernels import paf_line_scores


# ---------------------------------------------------------------------------
# Device side
# ---------------------------------------------------------------------------


def group_peaks_by_node(
    peaks: torch.Tensor,
    peak_vals: torch.Tensor,
    channel_inds: torch.Tensor,
    valid: torch.Tensor,
    n_nodes: int,
    k_per_node: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Rearrange flat top-K peaks into per-node slots.

    Args:
        peaks: ``(B, K, 2)``; peak_vals ``(B, K)``; channel_inds ``(B, K)``
            int32 (-1 invalid); valid ``(B, K)`` bool.

    Returns:
        ``(grouped_peaks (B, N, k, 2), grouped_vals (B, N, k), mask (B, N, k))``
        — per node, peaks in input (value-descending) order, NaN/0/False
        beyond each node's count; peaks past ``k_per_node`` are dropped.
    """
    b, k_in = peak_vals.shape
    dev = peaks.device
    node_ids = torch.arange(n_nodes, device=dev)[None, :, None]  # (1, N, 1)
    is_node = (channel_inds[:, None, :] == node_ids) & valid[:, None, :]  # (B, N, K)
    slot = torch.cumsum(is_node.to(torch.int32), dim=-1) - 1
    keep = is_node & (slot < k_per_node)
    # Rejected peaks go to an extra slot k_per_node, sliced off at the end
    # (the JAX package's scatter drops them with mode="drop").
    slot_target = torch.where(keep, slot, torch.full_like(slot, k_per_node)).long()
    b_idx = torch.arange(b, device=dev)[:, None, None].expand_as(slot_target)
    n_idx = torch.arange(n_nodes, device=dev)[None, :, None].expand_as(slot_target)

    grouped_peaks = torch.full((b, n_nodes, k_per_node + 1, 2), float("nan"),
                               dtype=peaks.dtype, device=dev)
    grouped_vals = torch.zeros((b, n_nodes, k_per_node + 1), dtype=peak_vals.dtype, device=dev)
    mask = torch.zeros((b, n_nodes, k_per_node + 1), dtype=torch.bool, device=dev)
    grouped_peaks[b_idx, n_idx, slot_target] = peaks[:, None, :, :].expand(b, n_nodes, k_in, 2)
    grouped_vals[b_idx, n_idx, slot_target] = peak_vals[:, None, :].expand(b, n_nodes, k_in)
    mask[b_idx, n_idx, slot_target] = keep
    # Contiguous copies: the line-scoring kernel takes dense tensors.
    return tuple(x[:, :, :k_per_node].contiguous() for x in (grouped_peaks, grouped_vals, mask))


def line_fractions(n_points: int, device=None) -> torch.Tensor:
    """``jnp.linspace(0.0, 1.0, n_points)`` in f32, bit for bit.

    ``jnp.linspace`` computes ``arange(P) * f32(1 / (P - 1))`` and sets the
    last element to 1; ``torch.linspace`` rounds differently (e.g. at P = 7).
    """
    if n_points == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = float(np.float32(1.0 / (n_points - 1)))
    t = torch.arange(n_points, dtype=torch.float32, device=device) * step
    t[-1] = 1.0
    return t


def score_paf_lines_dense(
    pafs: torch.Tensor,
    grouped_peaks: torch.Tensor,
    grouped_mask: torch.Tensor,
    edge_inds: torch.Tensor,
    n_line_points: int = 10,
    pafs_stride: int = 4,
    max_edge_length_ratio: float = 0.25,
    dist_penalty_weight: float = 1.0,
    t: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense PAF line scores for every candidate pair of every edge.

    Args:
        pafs: ``(B, Hp, Wp, 2*n_edges)`` channel order [e0x, e0y, e1x, ...].
        grouped_peaks: ``(B, n_nodes, K, 2)`` image-scale (x, y).
        grouped_mask: ``(B, n_nodes, K)`` bool.
        edge_inds: ``(n_edges, 2)`` int32 (src_node, dst_node), on pafs' device.
        t: the ``line_fractions(n_line_points)`` on pafs' device; built here
            when not given (:class:`PAFScorer` passes its own copy).

    Returns:
        ``(B, n_edges, K, K)`` scores; ``-inf`` where either endpoint is
        invalid. Score = mean over line points of PAF . unit_displacement +
        distance penalty (see :func:`~sleap_nn_tpu_torch.ops.kernels.paf_line_scores`).
    """
    _, hp, wp, _ = pafs.shape
    n_edges = edge_inds.shape[0]
    max_edge_length = max_edge_length_ratio * max(hp, wp, 2 * n_edges) * pafs_stride
    if t is None:
        t = line_fractions(n_line_points, device=pafs.device)
    # The kernel takes dense inputs, pafs aligned to an (x, y) channel pair
    # and grouped_peaks to 8 bytes; any other layout is copied first. The
    # predict path's inputs already are such tensors (the PAF head's NHWC
    # output keeps channels-last memory), so it copies nothing.
    return paf_line_scores(_dense(pafs, 2 * pafs.element_size()), _dense(grouped_peaks, 8),
                           _dense(grouped_mask), _dense(edge_inds), _dense(t),
                           pafs_stride, max_edge_length, dist_penalty_weight)


def _dense(x: torch.Tensor, align: int = 1) -> torch.Tensor:
    """``x``, or a fresh dense copy where it is not contiguous or its data
    does not start on an ``align``-byte boundary."""
    if x.is_contiguous() and x.data_ptr() % align == 0:
        return x
    return x.clone(memory_format=torch.contiguous_format)


# ---------------------------------------------------------------------------
# Host side
# ---------------------------------------------------------------------------


def toposort_edges(edge_inds: Sequence[Tuple[int, int]]) -> Tuple[int, ...]:
    """Breadth-first order of edges from the topological root.

    The root is the first node, in order of appearance, with no incoming
    edge; the walk visits each node's successors in edge order and lists
    the edges that reach a new node, then every other edge in index order.
    With no root (every node on a cycle) the order is the index order.
    This is the order ``nx.bfs_edges(dg, next(nx.topological_sort(dg)))``
    gives, which the JAX package uses.
    """
    edge_list = [tuple(e) for e in edge_inds]
    succ: Dict[int, Dict[int, None]] = {}
    has_pred = set()
    for s, d in edge_list:
        succ.setdefault(s, {})[d] = None
        succ.setdefault(d, {})
        has_pred.add(d)
    root = next((n for n in succ if n not in has_pred), None)
    if root is None:
        return tuple(range(len(edge_list)))
    order, seen, queue = [], {root}, deque([root])
    while queue:
        parent = queue.popleft()
        for child in succ[parent]:
            if child not in seen:
                seen.add(child)
                order.append((parent, child))
                queue.append(child)
    out = [edge_list.index(e) for e in order]
    out += [i for i in range(len(edge_list)) if i not in out]
    return tuple(out)


def match_candidates_dense(
    scores: np.ndarray, min_line_scores: float = 0.25
) -> List[Tuple[int, int, int, float]]:
    """Hungarian matching per edge on the dense score matrix of ONE sample.

    Args:
        scores: ``(n_edges, K, K)`` with -inf at invalid pairs.

    Returns:
        List of ``(edge_ind, src_slot, dst_slot, score)`` matches above
        ``min_line_scores``.
    """
    matches = []
    for e in range(scores.shape[0]):
        s = scores[e]
        valid_src = np.where(np.isfinite(s).any(axis=1))[0]
        valid_dst = np.where(np.isfinite(s).any(axis=0))[0]
        if len(valid_src) == 0 or len(valid_dst) == 0:
            continue
        cost = -s[np.ix_(valid_src, valid_dst)]
        cost[~np.isfinite(cost)] = 1e9
        rows, cols = linear_sum_assignment(cost)
        for r, c in zip(rows, cols):
            score = float(-cost[r, c])
            if score <= -1e8:
                continue
            if score >= min_line_scores:
                matches.append((e, int(valid_src[r]), int(valid_dst[c]), score))
    return matches


def assign_connections_to_instances(
    connections: Dict[int, List[Tuple[int, int, float]]],
    edge_inds: Sequence[Tuple[int, int]],
    sorted_edge_inds: Sequence[int],
    min_instance_peaks=0,
    n_nodes: Optional[int] = None,
) -> Dict[Tuple[int, int], int]:
    """Greedy union of matched connections into instances.

    Keys are ``(node_ind, slot)`` peak IDs; values are instance ids. A
    float ``min_instance_peaks`` is a fraction of ``n_nodes``.
    """
    assignments: Dict[Tuple[int, int], int] = {}
    for e in sorted_edge_inds:
        src_node, dst_node = edge_inds[e]
        for src_slot, dst_slot, _score in connections.get(e, []):
            src_id = (src_node, src_slot)
            dst_id = (dst_node, dst_slot)
            src_inst = assignments.get(src_id)
            dst_inst = assignments.get(dst_id)
            if src_inst is None and dst_inst is None:
                new_inst = max(assignments.values(), default=-1) + 1
                assignments[src_id] = new_inst
                assignments[dst_id] = new_inst
            elif src_inst is not None and dst_inst is None:
                assignments[dst_id] = src_inst
            elif src_inst is None and dst_inst is not None:
                assignments[src_id] = dst_inst
            else:
                assignments[dst_id] = src_inst
                src_nodes = {p[0] for p, i in assignments.items() if i == src_inst}
                dst_nodes = {p[0] for p, i in assignments.items() if i == dst_inst}
                if not src_nodes & dst_nodes:
                    for pid, inst in list(assignments.items()):
                        if inst == dst_inst:
                            assignments[pid] = src_inst

    if min_instance_peaks:
        if isinstance(min_instance_peaks, float):
            min_instance_peaks = int(min_instance_peaks * (n_nodes or 1))
        counts: Dict[int, int] = {}
        for inst in assignments.values():
            counts[inst] = counts.get(inst, 0) + 1
        assignments = {
            pid: inst for pid, inst in assignments.items() if counts[inst] >= min_instance_peaks
        }
    return assignments


def make_predicted_instances(
    grouped_peaks: np.ndarray,
    grouped_vals: np.ndarray,
    connections: Dict[int, List[Tuple[int, int, float]]],
    assignments: Dict[Tuple[int, int], int],
    edge_inds: Sequence[Tuple[int, int]],
    n_nodes: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Collect assigned peaks into ``(points (I, N, 2), vals (I, N), scores (I,))``."""
    instance_ids = sorted(set(assignments.values()))
    id_map = {inst: i for i, inst in enumerate(instance_ids)}
    n_inst = len(instance_ids)

    pts = np.full((n_inst, n_nodes, 2), np.nan, dtype=np.float32)
    vals = np.full((n_inst, n_nodes), np.nan, dtype=np.float32)
    inst_scores = np.zeros((n_inst,), dtype=np.float32)

    for (node, slot), inst in assignments.items():
        i = id_map[inst]
        pts[i, node] = grouped_peaks[node, slot]
        vals[i, node] = grouped_vals[node, slot]

    for e, conns in connections.items():
        src_node, dst_node = edge_inds[e]
        for src_slot, dst_slot, score in conns:
            inst = assignments.get((src_node, src_slot))
            if inst is not None and inst == assignments.get((dst_node, dst_slot)):
                inst_scores[id_map[inst]] += score
    return pts, vals, inst_scores


@dataclasses.dataclass
class PAFScorer:
    """Device scoring + host grouping of one skeleton's PAFs.

    Picklable: a grouping pool ships it to its workers. Its device copies
    of the edge indices (per device) and of the line fractions ``t`` (per
    ``n_points`` and device) are made once and are not pickled.
    """

    part_names: Sequence[str]
    edges: Sequence[Tuple[str, str]]
    pafs_stride: int = 4
    max_edge_length_ratio: float = 0.25
    dist_penalty_weight: float = 1.0
    n_points: int = 10
    min_instance_peaks: float = 0
    min_line_scores: float = 0.25
    k_per_node: int = 20

    def __post_init__(self):
        names = list(self.part_names)
        self.edge_inds = [(names.index(s), names.index(d)) for s, d in self.edges]
        self.n_nodes = len(names)
        self.n_edges = len(self.edge_inds)
        self.sorted_edge_inds = toposort_edges(self.edge_inds)
        self._device_edge_inds: Dict[torch.device, torch.Tensor] = {}
        self._device_t: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_device_edge_inds"] = {}
        state["_device_t"] = {}
        return state

    # Both made once: a copy from pageable host memory on every batch would
    # wait for the device's queue, and building t takes three launches.
    def _edge_inds_on(self, device: torch.device) -> torch.Tensor:
        if device not in self._device_edge_inds:
            self._device_edge_inds[device] = torch.tensor(
                self.edge_inds, dtype=torch.int32, device=device).reshape(-1, 2)
        return self._device_edge_inds[device]

    def _line_fractions_on(self, device: torch.device) -> torch.Tensor:
        key = (self.n_points, device)
        if key not in self._device_t:
            self._device_t[key] = line_fractions(self.n_points, device=device)
        return self._device_t[key]

    # -- device ---------------------------------------------------------------
    def score_lines(self, pafs, grouped_peaks, mask):
        """Dense ``(B, E, K, K)`` line scores of grouped peaks, on pafs' device."""
        return score_paf_lines_dense(
            pafs,
            grouped_peaks,
            mask,
            self._edge_inds_on(pafs.device),
            n_line_points=self.n_points,
            pafs_stride=self.pafs_stride,
            max_edge_length_ratio=self.max_edge_length_ratio,
            dist_penalty_weight=self.dist_penalty_weight,
            t=self._line_fractions_on(pafs.device),
        )

    def score_on_device(self, pafs, peaks, peak_vals, channel_inds, valid):
        """Flat top-K peaks -> (grouped peaks/vals/mask, dense scores), on pafs' device."""
        grouped_peaks, grouped_vals, mask = group_peaks_by_node(
            peaks, peak_vals, channel_inds, valid, self.n_nodes, self.k_per_node
        )
        return grouped_peaks, grouped_vals, mask, self.score_lines(pafs, grouped_peaks, mask)

    # -- host -------------------------------------------------------------------
    def group_sample(self, grouped_peaks, grouped_vals, scores,
                     return_matches: bool = False):
        """Host: dense scores of one sample -> predicted instance arrays.

        With ``return_matches`` also returns the matched candidate edges as
        ``(edge, src_slot, dst_slot, line_score)`` tuples (the Hungarian
        result already computed, for ``return_paf_graph`` output).
        """
        matches = match_candidates_dense(np.asarray(scores), self.min_line_scores)
        connections: Dict[int, List[Tuple[int, int, float]]] = {}
        for e, s, d, sc in matches:
            connections.setdefault(e, []).append((s, d, sc))
        assignments = assign_connections_to_instances(
            connections,
            self.edge_inds,
            self.sorted_edge_inds,
            min_instance_peaks=self.min_instance_peaks,
            n_nodes=self.n_nodes,
        )
        inst = make_predicted_instances(
            np.asarray(grouped_peaks),
            np.asarray(grouped_vals),
            connections,
            assignments,
            self.edge_inds,
            self.n_nodes,
        )
        if return_matches:
            return inst + (matches,)
        return inst
