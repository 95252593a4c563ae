"""Pose/mask track reconciliation (numpy + scipy only): the PyTorch
port's counterpart of ``sleap_nn_tpu/inference/sam/reconciliation.py``,
a copy.

Parity target: reference sleap_nn/inference/sam/reconciliation.py
(:175 IDReconciler, :459 MaskReconciler, :706-778 predicates,
:781 TrackNameResolver). Matches identity-consistent per-frame masks against
pose instances (Hungarian on keypoints-inside) or against anchor masks
(Hungarian on IoU), detects identity swaps, and propagates sparse anchor-frame
name assignments to every frame via nearest-anchor lookup.

Host-side by design: Hungarian assignment and per-track bookkeeping are
sequential CPU work, the same placement this framework uses for PAF grouping
and tracking.
"""

from __future__ import annotations

import bisect
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment


@dataclass
class MatchContext:
    """Per-candidate-match facts a predicate can gate on."""

    frame_idx: int
    obj_id: int
    cost: float
    keypoints_inside: int
    keypoints_visible: int
    mask_area: int
    mask_centroid: Tuple[float, float]


MatchPredicate = Callable[[object, np.ndarray, MatchContext], bool]


@dataclass
class TrackAssignment:
    """One pose->mask assignment at a frame."""

    frame_idx: int
    pose_track_name: Optional[str]
    pose_idx: int
    obj_id: int
    confidence: float
    mask_score: float = 1.0


@dataclass
class SwapEvent:
    """A track name matched to a different mask object id than before."""

    frame_idx: int
    track_name: str
    old_obj_id: int
    new_obj_id: int


@dataclass
class MaskAssignment:
    """One anchor-mask -> produced-mask assignment at a frame."""

    frame_idx: int
    input_track_id: int
    input_track_name: Optional[str]
    obj_id: int
    iou: float
    mask_score: float = 1.0


def default_match_predicate(pose, mask: np.ndarray, ctx: MatchContext) -> bool:
    """Weakest useful gate: at least one keypoint inside the mask."""
    return ctx.keypoints_inside >= 1


def require_min_keypoints_inside(min_count: int = 3) -> MatchPredicate:
    """Gate: >= ``min_count`` visible keypoints inside the mask."""

    def predicate(pose, mask, ctx):
        return ctx.keypoints_inside >= min_count

    return predicate


def require_min_fraction_inside(min_frac: float = 0.5) -> MatchPredicate:
    """Gate: >= ``min_frac`` of the visible keypoints inside the mask."""

    def predicate(pose, mask, ctx):
        if ctx.keypoints_visible == 0:
            return False
        return ctx.keypoints_inside / ctx.keypoints_visible >= min_frac

    return predicate


def require_centroid_proximity(max_dist: float = 100.0) -> MatchPredicate:
    """Gate: pose centroid within ``max_dist`` px of the mask centroid."""

    def predicate(pose, mask, ctx):
        pc = np.nanmean(np.asarray(pose.numpy(), float), axis=0)
        if np.isnan(pc).any():
            return False
        return float(np.linalg.norm(pc - np.asarray(ctx.mask_centroid))) <= max_dist

    return predicate


def require_reasonable_mask_area(min_area: int = 1000, max_area: int = 500_000) -> MatchPredicate:
    """Gate: mask area within ``[min_area, max_area]`` px."""

    def predicate(pose, mask, ctx):
        return min_area <= ctx.mask_area <= max_area

    return predicate


def _visible_rows(coords: np.ndarray, node_names: Sequence[str],
                  exclude: Set[str]) -> np.ndarray:
    """Boolean per-node visibility (finite xy, not excluded)."""
    vis = np.isfinite(coords).all(axis=1)
    if exclude:
        for j, name in enumerate(node_names):
            if name in exclude:
                vis[j] = False
    return vis


@dataclass
class IDReconciler:
    """Hungarian pose<->mask matching on keypoints-inside-mask.

    Accumulates :class:`TrackAssignment` across frames; ``detect_swaps`` and
    ``build_id_map`` consume the accumulated history. The default predicate
    requires >= 3 keypoints inside the mask (reference :210).
    """

    skeleton: object
    exclude_nodes: Set[str] = field(default_factory=set)
    match_predicates: List[MatchPredicate] = field(default_factory=list)
    ignore_gt_tracks: bool = False
    _assignments: List[TrackAssignment] = field(default_factory=list, repr=False)

    def __post_init__(self):
        if not self.match_predicates:
            self.match_predicates = [require_min_keypoints_inside(3)]

    @property
    def _node_names(self) -> List[str]:
        nodes = getattr(self.skeleton, "node_names", None)
        if nodes is not None:
            return list(nodes)
        return [n.name for n in self.skeleton.nodes]

    def compute_cost_matrix(self, poses: Sequence, masks: np.ndarray) -> np.ndarray:
        """Cost = -(# visible keypoints inside mask), shape (n_poses, n_masks)."""
        n_poses, n_masks = len(poses), len(masks)
        cost = np.zeros((n_poses, n_masks))
        if n_poses == 0 or n_masks == 0:
            return cost
        node_names = self._node_names
        h, w = masks.shape[1], masks.shape[2]
        flat = masks.reshape(n_masks, -1).astype(bool)
        for i, pose in enumerate(poses):
            coords = np.asarray(pose.numpy(), float)
            vis = _visible_rows(coords, node_names, self.exclude_nodes)
            pts = coords[vis].astype(int)
            if len(pts) == 0:
                continue
            inb = (pts[:, 0] >= 0) & (pts[:, 0] < w) & (pts[:, 1] >= 0) & (pts[:, 1] < h)
            pts = pts[inb]
            if len(pts) == 0:
                continue
            lin = pts[:, 1] * w + pts[:, 0]
            cost[i] = -flat[:, lin].sum(axis=1)
        return cost

    def match_frame(
        self,
        frame_idx: int,
        poses: Sequence,
        masks: np.ndarray,
        object_ids: np.ndarray,
        scores: Optional[np.ndarray] = None,
    ) -> List[TrackAssignment]:
        """Hungarian-match one frame, filter through predicates, accumulate."""
        if len(poses) == 0 or len(masks) == 0:
            return []
        masks = np.asarray(masks)
        if masks.ndim == 4 and masks.shape[1] == 1:
            masks = masks.squeeze(axis=1)
        if scores is None:
            scores = np.ones(len(object_ids))
        if len(object_ids) != len(masks) or len(scores) != len(masks):
            raise ValueError(
                f"match_frame: frame {frame_idx} has {len(masks)} masks but "
                f"{len(object_ids)} object_ids / {len(scores)} scores."
            )

        cost = self.compute_cost_matrix(poses, masks)
        rows, cols = linear_sum_assignment(cost)
        node_names = self._node_names

        out: List[TrackAssignment] = []
        for pi, mi in zip(rows, cols):
            pose, mask = poses[pi], masks[mi]
            coords = np.asarray(pose.numpy(), float)
            vis_count = int(_visible_rows(coords, node_names, self.exclude_nodes).sum())
            ys, xs = np.nonzero(mask)
            centroid = (float(xs.mean()), float(ys.mean())) if len(xs) else (0.0, 0.0)
            inside = int(-cost[pi, mi])
            ctx = MatchContext(
                frame_idx=frame_idx,
                obj_id=int(object_ids[mi]),
                cost=float(cost[pi, mi]),
                keypoints_inside=inside,
                keypoints_visible=vis_count,
                mask_area=int(len(xs)),
                mask_centroid=centroid,
            )
            if not all(p(pose, mask, ctx) for p in self.match_predicates):
                continue
            track = getattr(pose, "track", None)
            name = None if self.ignore_gt_tracks else (track.name if track else None)
            out.append(
                TrackAssignment(
                    frame_idx=frame_idx,
                    pose_track_name=name,
                    pose_idx=int(pi),
                    obj_id=ctx.obj_id,
                    confidence=inside / vis_count if vis_count else 0.0,
                    mask_score=float(scores[mi]),
                )
            )
        self._assignments.extend(out)
        return out

    def detect_swaps(self) -> List[SwapEvent]:
        """Identity swaps: a track name mapping to different obj_ids over time."""
        return _detect_swaps(
            [(a.pose_track_name, a.frame_idx, a.obj_id)
             for a in self._assignments if a.pose_track_name]
        )

    def build_id_map(self) -> Dict[int, Dict[int, str]]:
        """frame_idx -> {obj_id: track_name} from named assignments."""
        by_frame: Dict[int, Dict[int, str]] = defaultdict(dict)
        for a in self._assignments:
            if a.pose_track_name:
                by_frame[a.frame_idx][a.obj_id] = a.pose_track_name
        return dict(by_frame)

    def get_assignments(self) -> List[TrackAssignment]:
        return list(self._assignments)

    def clear(self) -> None:
        self._assignments.clear()


def _detect_swaps(entries: List[Tuple[str, int, int]]) -> List[SwapEvent]:
    """Shared swap detection over (track_name, frame_idx, obj_id) entries."""
    by_track: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    for name, fi, oid in entries:
        by_track[name].append((fi, oid))
    swaps: List[SwapEvent] = []
    for name, seq in by_track.items():
        seq.sort()
        for (_, prev_oid), (fi, oid) in zip(seq, seq[1:]):
            if prev_oid != oid:
                swaps.append(SwapEvent(frame_idx=fi, track_name=name,
                                       old_obj_id=prev_oid, new_obj_id=oid))
    return swaps


@dataclass
class MaskReconciler:
    """Hungarian anchor-mask<->produced-mask matching on IoU.

    For workflows with user-corrected masks at sparse frames acting as
    identity anchors (reference :459). The IoU cost matrix is computed as one
    boolean matmul over flattened masks rather than a Python double loop.
    """

    min_iou: float = 0.3
    track_names: Dict[int, str] = field(default_factory=dict)
    _assignments: List[MaskAssignment] = field(default_factory=list, repr=False)

    @staticmethod
    def compute_iou(mask1: np.ndarray, mask2: np.ndarray) -> float:
        """IoU of two boolean masks (0.0 on empty union)."""
        m1, m2 = np.asarray(mask1, bool), np.asarray(mask2, bool)
        union = np.logical_or(m1, m2).sum()
        if union == 0:
            return 0.0
        return float(np.logical_and(m1, m2).sum() / union)

    def compute_cost_matrix(self, input_masks: np.ndarray, out_masks: np.ndarray) -> np.ndarray:
        """Cost = -IoU matrix, shape (n_input, n_out), fully vectorized."""
        out_masks = np.asarray(out_masks)
        if out_masks.ndim == 4 and out_masks.shape[1] == 1:
            out_masks = out_masks.squeeze(axis=1)
        n_in, n_out = len(input_masks), len(out_masks)
        if n_in == 0 or n_out == 0:
            return np.zeros((n_in, n_out))
        a = np.asarray(input_masks, bool).reshape(n_in, -1)
        b = np.asarray(out_masks, bool).reshape(n_out, -1)
        inter = a.astype(np.float64) @ b.astype(np.float64).T
        union = a.sum(axis=1)[:, None] + b.sum(axis=1)[None, :] - inter
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(union > 0, inter / union, 0.0)
        return -iou

    def match_frame(
        self,
        frame_idx: int,
        input_masks: np.ndarray,
        input_track_ids: np.ndarray,
        out_masks: np.ndarray,
        out_obj_ids: np.ndarray,
        scores: Optional[np.ndarray] = None,
    ) -> List[MaskAssignment]:
        """Hungarian-match one frame's anchor masks to produced masks."""
        if len(input_masks) == 0 or len(out_masks) == 0:
            return []
        if scores is None:
            scores = np.ones(len(out_obj_ids))
        cost = self.compute_cost_matrix(input_masks, out_masks)
        rows, cols = linear_sum_assignment(cost)
        out: List[MaskAssignment] = []
        for ii, oi in zip(rows, cols):
            iou = -cost[ii, oi]
            if iou < self.min_iou:
                continue
            tid = int(input_track_ids[ii])
            out.append(
                MaskAssignment(
                    frame_idx=frame_idx,
                    input_track_id=tid,
                    input_track_name=self.track_names.get(tid),
                    obj_id=int(out_obj_ids[oi]),
                    iou=float(iou),
                    mask_score=float(scores[oi]),
                )
            )
        self._assignments.extend(out)
        return out

    def _name(self, a: MaskAssignment) -> str:
        return (a.input_track_name or self.track_names.get(a.input_track_id)
                or f"track_{a.input_track_id}")

    def detect_swaps(self) -> List[SwapEvent]:
        """Identity swaps: an anchor track matched to different obj_ids over time."""
        return _detect_swaps(
            [(self._name(a), a.frame_idx, a.obj_id) for a in self._assignments]
        )

    def build_id_map(self) -> Dict[int, Dict[int, str]]:
        """frame_idx -> {obj_id: track_name}."""
        by_frame: Dict[int, Dict[int, str]] = defaultdict(dict)
        for a in self._assignments:
            by_frame[a.frame_idx][a.obj_id] = self._name(a)
        return dict(by_frame)

    def get_assignments(self) -> List[MaskAssignment]:
        return list(self._assignments)

    def get_iou_stats(self) -> Dict[str, float]:
        """min/max/mean/median IoU across accumulated assignments."""
        if not self._assignments:
            return {"min": 0.0, "max": 0.0, "mean": 0.0, "median": 0.0}
        ious = np.array([a.iou for a in self._assignments])
        return {"min": float(ious.min()), "max": float(ious.max()),
                "mean": float(ious.mean()), "median": float(np.median(ious))}

    def clear(self) -> None:
        self._assignments.clear()


@dataclass
class TrackNameResolver:
    """Propagate sparse anchor-frame ``{obj_id: name}`` maps to all frames.

    Each frame resolves through its *nearest* anchor frame (binary search via
    ``bisect``), falling back to ``fallback_names`` then ``track_{obj_id}``
    (reference :781; linear scan replaced by bisect).
    """

    gt_anchors: Dict[int, Dict[int, str]] = field(default_factory=dict)
    fallback_names: Dict[int, str] = field(default_factory=dict)
    _anchor_frames: List[int] = field(default_factory=list, repr=False)

    def __post_init__(self):
        self._anchor_frames = sorted(self.gt_anchors.keys())

    @classmethod
    def from_reconciler(cls, reconciler, fallback_names: Optional[Dict[int, str]] = None
                        ) -> "TrackNameResolver":
        return cls(gt_anchors=reconciler.build_id_map(),
                   fallback_names=fallback_names or {})

    @classmethod
    def from_id_map(cls, id_map: Dict[int, Dict[int, str]],
                    fallback_names: Optional[Dict[int, str]] = None) -> "TrackNameResolver":
        return cls(gt_anchors=dict(id_map), fallback_names=fallback_names or {})

    def _find_nearest_anchor(self, frame_idx: int) -> Optional[int]:
        frames = self._anchor_frames
        if not frames:
            return None
        i = bisect.bisect_left(frames, frame_idx)
        if i == 0:
            return frames[0]
        if i == len(frames):
            return frames[-1]
        before, after = frames[i - 1], frames[i]
        return before if frame_idx - before <= after - frame_idx else after

    def get_mapping_at_frame(self, frame_idx: int) -> Dict[int, str]:
        nearest = self._find_nearest_anchor(frame_idx)
        return {} if nearest is None else self.gt_anchors[nearest]

    def get_track_name(self, frame_idx: int, obj_id: int,
                       default: Optional[str] = None) -> str:
        mapping = self.get_mapping_at_frame(frame_idx)
        if obj_id in mapping:
            return mapping[obj_id]
        if obj_id in self.fallback_names:
            return self.fallback_names[obj_id]
        return default if default is not None else f"track_{obj_id}"

    def resolve_all_frames(self, total_frames: int) -> Dict[int, Dict[int, str]]:
        """frame_idx -> nearest-anchor mapping for every frame in [0, total)."""
        if not self._anchor_frames:
            return {}
        return {fi: self.gt_anchors[self._find_nearest_anchor(fi)]
                for fi in range(total_frames)}

    def get_anchor_frames(self) -> List[int]:
        return list(self._anchor_frames)

    def get_all_track_names(self) -> Set[str]:
        return {name for m in self.gt_anchors.values() for name in m.values()}

    def get_all_obj_ids(self) -> Set[int]:
        return {oid for m in self.gt_anchors.values() for oid in m.keys()}

    def get_canonical_mapping(self) -> Dict[int, str]:
        """One global obj_id -> name map (first-seen across anchors, in frame order)."""
        canonical: Dict[int, str] = {}
        for fi in self._anchor_frames:
            for oid, name in self.gt_anchors[fi].items():
                canonical.setdefault(oid, name)
        return canonical

    def get_anchor_source(self, frame_idx: int) -> Tuple[Optional[int], str]:
        """(anchor_frame, direction) for debugging: anchor/forward/backward/none."""
        nearest = self._find_nearest_anchor(frame_idx)
        if nearest is None:
            return (None, "none")
        if frame_idx == nearest:
            return (nearest, "anchor")
        return (nearest, "forward" if frame_idx > nearest else "backward")


def majority_vote_names(id_map: Dict[int, Dict[int, str]]
                        ) -> Tuple[Dict[int, str], Set[int]]:
    """Name each obj_id by majority vote across anchor frames.

    Returns ``(canonical, ambiguous)``: obj_ids with a strict majority get a
    global name (immune to a minority of swapped anchor frames); exact ties
    are ambiguous and should resolve per-frame via the nearest anchor.
    """
    votes: Dict[int, Counter] = defaultdict(Counter)
    for mapping in id_map.values():
        for oid, name in mapping.items():
            votes[oid][name] += 1
    canonical: Dict[int, str] = {}
    ambiguous: Set[int] = set()
    for oid, counter in votes.items():
        ranked = counter.most_common()
        if len(ranked) == 1 or ranked[0][1] > ranked[1][1]:
            canonical[oid] = ranked[0][0]
        else:
            ambiguous.add(oid)
    return canonical, ambiguous
