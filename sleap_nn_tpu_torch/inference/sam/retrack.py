"""Mask-driven track refinement: the PyTorch port's counterpart of
``sleap_nn_tpu/inference/sam/retrack.py``, a copy (reference
sleap_nn/inference/sam/retrack.py:141).

``retrack()`` corrects the identities of already-predicted pose instances from
identity-consistent per-frame masks: Hungarian-match each frame's poses to its
masks, anchor the ``obj_id -> track_name`` identity on trusted (user-tracked)
frames, name each obj_id by majority vote across anchors (so a minority of
swapped anchor frames cannot flip a stable identity), and relabel every
matched instance. Numpy + scipy only — no model, no torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from sleap_nn_tpu_torch.inference.sam.reconciliation import (
    IDReconciler,
    MatchPredicate,
    TrackAssignment,
    TrackNameResolver,
    majority_vote_names,
)
from sleap_nn_tpu_torch.io.model import Instance, LabeledFrame, PredictedInstance, Track


@dataclass
class RetrackResult:
    """Output of :func:`retrack`.

    ``canonical_map`` holds the majority-vote obj_id -> name decisions;
    ambiguous (tied) obj_ids are absent there and resolve per-frame via
    ``resolver``'s nearest anchor.
    """

    labeled_frames: List[LabeledFrame] = field(default_factory=list)
    assignments: List[TrackAssignment] = field(default_factory=list)
    id_map: Dict[int, Dict[int, str]] = field(default_factory=dict)
    canonical_map: Dict[int, str] = field(default_factory=dict)
    resolver: Optional[TrackNameResolver] = None
    num_relabeled: int = 0
    num_matched: int = 0
    anchor_frames: List[int] = field(default_factory=list)


def _is_anchor_instance(inst) -> bool:
    """A trusted identity anchor: a *user* instance carrying a track.

    ``type(inst) is Instance`` (not the PredictedInstance subclass)
    distinguishes hand labels from predictions, mirroring the reference's GT
    precedence rule (retrack.py:85).
    """
    return type(inst) is Instance and inst.track is not None


def _strip_padding(masks: np.ndarray, object_ids: np.ndarray
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Drop padded rows (obj_id < 0) and squeeze (N, 1, H, W) -> (N, H, W).

    Returns (masks, object_ids, keep_mask) so per-frame scores can be aligned
    with the same keep mask.
    """
    object_ids = np.asarray(object_ids)
    masks = np.asarray(masks)
    if masks.ndim == 4 and masks.shape[1] == 1:
        masks = masks.squeeze(axis=1)
    keep = object_ids >= 0 if object_ids.size else np.ones(0, bool)
    if object_ids.size and not keep.all():
        masks, object_ids = masks[keep], object_ids[keep]
    return masks, object_ids, keep


def retrack(
    labeled_frames: Sequence[LabeledFrame],
    masks: Sequence[np.ndarray],
    object_ids: Sequence[np.ndarray],
    skeleton,
    *,
    scores: Optional[Sequence[np.ndarray]] = None,
    match_predicates: Optional[List[MatchPredicate]] = None,
    exclude_nodes: Optional[Set[str]] = None,
    anchor_frame_indices: Optional[Sequence[int]] = None,
    fallback_names: Optional[Dict[int, str]] = None,
    in_place: bool = True,
) -> RetrackResult:
    """Refine instance track identities from per-frame masks.

    ``masks[i]`` / ``object_ids[i]`` are positionally aligned to
    ``labeled_frames[i]``; obj_id entries ``< 0`` are padding and dropped.
    Anchor frames default to those containing a user-tracked instance (all
    frames when none exist). With ``in_place=False`` a deep copy is corrected
    and returned; the inputs stay untouched.
    """
    n = len(labeled_frames)
    if len(masks) != n or len(object_ids) != n:
        raise ValueError(
            f"labeled_frames/masks/object_ids length mismatch: {n}, "
            f"{len(masks)}, {len(object_ids)}."
        )
    if scores is not None and len(scores) != n:
        raise ValueError(f"scores length {len(scores)} != {n} frames.")

    frames: List[LabeledFrame] = list(labeled_frames)
    if not in_place:
        from copy import deepcopy

        # One deepcopy over the whole list keeps shared Track objects shared.
        frames = deepcopy(frames)

    if anchor_frame_indices is not None:
        anchor_set = {int(i) for i in anchor_frame_indices}
    else:
        anchor_set = {
            i for i, lf in enumerate(frames)
            if any(_is_anchor_instance(inst) for inst in lf.instances)
        }
        if not anchor_set:
            anchor_set = set(range(n))

    reconciler = IDReconciler(
        skeleton=skeleton,
        exclude_nodes=set(exclude_nodes) if exclude_nodes else set(),
        match_predicates=list(match_predicates) if match_predicates else [],
    )

    pose_to_obj_per_frame: List[Dict[int, int]] = []
    for i, lf in enumerate(frames):
        m_i, o_i, keep = _strip_padding(masks[i], object_ids[i])
        s_i = None
        if scores is not None:
            s_i = np.asarray(scores[i])
            if s_i.size and len(s_i) == len(keep) and not keep.all():
                s_i = s_i[keep]
        assigned = reconciler.match_frame(
            frame_idx=i, poses=list(lf.instances), masks=m_i,
            object_ids=o_i, scores=s_i,
        )
        pose_to_obj_per_frame.append({a.pose_idx: a.obj_id for a in assigned})

    # Only trusted frames define the obj_id -> name identity.
    id_map: Dict[int, Dict[int, str]] = {}
    for a in reconciler.get_assignments():
        if a.frame_idx in anchor_set and a.pose_track_name:
            id_map.setdefault(a.frame_idx, {})[a.obj_id] = a.pose_track_name

    resolver = TrackNameResolver.from_id_map(id_map, fallback_names=fallback_names or {})
    canonical_map, ambiguous = majority_vote_names(id_map)

    track_by_name: Dict[str, Track] = {}
    for lf in frames:
        for inst in lf.instances:
            if inst.track is not None:
                track_by_name.setdefault(inst.track.name, inst.track)

    def _resolve(frame_idx: int, obj_id: int) -> Optional[str]:
        # Ambiguous obj_ids (tied votes = genuine cross-anchor reassignment)
        # flip at the midpoint via the nearest anchor; stable ids take the
        # global majority name; fallback last.
        if obj_id in ambiguous:
            mapping = resolver.get_mapping_at_frame(frame_idx)
            if obj_id in mapping:
                return mapping[obj_id]
        if obj_id in canonical_map:
            return canonical_map[obj_id]
        if fallback_names and obj_id in fallback_names:
            return fallback_names[obj_id]
        return None

    num_relabeled = num_matched = 0
    for i, lf in enumerate(frames):
        pose_to_obj = pose_to_obj_per_frame[i]
        for pose_idx, inst in enumerate(lf.instances):
            obj_id = pose_to_obj.get(pose_idx)
            if obj_id is None:
                continue
            num_matched += 1
            name = _resolve(i, obj_id)
            if name is None:
                continue
            track = track_by_name.setdefault(name, Track(name=name))
            if inst.track is not track:
                inst.track = track
                num_relabeled += 1

    return RetrackResult(
        labeled_frames=frames,
        assignments=reconciler.get_assignments(),
        id_map=id_map,
        canonical_map=canonical_map,
        resolver=resolver,
        num_relabeled=num_relabeled,
        num_matched=num_matched,
        anchor_frames=sorted(anchor_set),
    )
