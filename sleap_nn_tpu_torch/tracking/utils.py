"""Tracking utilities: matching, features, scorers, NMS, culling.

Port of ``sleap_nn_tpu/tracking/utils.py``. The ``"masks"`` feature
(``MaskFeature``, ``get_mask``, ``is_segmentation_mask``,
``compute_mask_iou``) waits for ``SegmentationMask`` and raises
``NotImplementedError`` (ROADMAP.md section 1, item 10).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from sleap_nn_tpu_torch.evaluation import compute_oks
from sleap_nn_tpu_torch.io.model import PredictedInstance

MASKS_UNPORTED = ("mask tracking needs SegmentationMask, which is not ported "
                  "(ROADMAP.md section 1, item 10)")


def hungarian_matching(cost_matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Optimal assignment; infinite costs are excluded after solving."""
    cost = np.where(np.isfinite(cost_matrix), cost_matrix, 1e9)
    rows, cols = linear_sum_assignment(cost)
    keep = cost[rows, cols] < 1e8
    return rows[keep], cols[keep]


def greedy_matching(cost_matrix: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy lowest-cost-first assignment."""
    cost = np.where(np.isfinite(cost_matrix), cost_matrix, np.inf).copy()
    rows, cols = [], []
    while np.isfinite(cost).any():
        r, c = np.unravel_index(np.argmin(cost), cost.shape)
        rows.append(int(r))
        cols.append(int(c))
        cost[r, :] = np.inf
        cost[:, c] = np.inf
    return np.asarray(rows, dtype=int), np.asarray(cols, dtype=int)


# -- feature extractors --------------------------------------------------------


def get_keypoints(inst) -> np.ndarray:
    if isinstance(inst, np.ndarray):
        return inst
    return inst.numpy()


def get_centroid(inst) -> np.ndarray:
    pts = get_keypoints(inst)
    return np.nanmean(pts, axis=0)


def get_bbox(inst) -> np.ndarray:
    pts = get_keypoints(inst)
    return np.array(
        [np.nanmin(pts[:, 0]), np.nanmin(pts[:, 1]), np.nanmax(pts[:, 0]), np.nanmax(pts[:, 1])]
    )


class MaskFeature:
    """The ``"masks"`` tracking feature (item 10)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(MASKS_UNPORTED)


def get_mask(obj) -> MaskFeature:
    raise NotImplementedError(MASKS_UNPORTED)


def is_segmentation_mask(obj) -> bool:
    raise NotImplementedError(MASKS_UNPORTED)


def compute_mask_iou(a, b) -> float:
    raise NotImplementedError(MASKS_UNPORTED)


def count_valid_points(inst) -> int:
    """The number of nodes with both coordinates."""
    pts = get_keypoints(inst)
    return int(np.sum(~np.isnan(pts).any(axis=-1)))


# -- scorers -------------------------------------------------------------------


def compute_euclidean_distance(a: np.ndarray, b: np.ndarray) -> float:
    """Negative euclidean distance (higher = better)."""
    a = np.asarray(a).reshape(-1)
    b = np.asarray(b).reshape(-1)
    return -float(np.linalg.norm(np.nan_to_num(a - b)))


def compute_oks_score(a: np.ndarray, b: np.ndarray, stddev: float = 0.025) -> float:
    a = np.asarray(a)
    b = np.asarray(b)
    return float(compute_oks(a[None], b[None], stddev=stddev)[0, 0])


def compute_iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of ``[x0, y0, x1, y1]`` boxes."""
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    ix0, iy0 = max(ax0, bx0), max(ay0, by0)
    ix1, iy1 = min(ax1, bx1), min(ay1, by1)
    iw, ih = max(0.0, ix1 - ix0), max(0.0, iy1 - iy0)
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return float(inter / union) if union > 0 else 0.0


def compute_cosine_sim(a: np.ndarray, b: np.ndarray) -> float:
    a = np.nan_to_num(np.asarray(a, dtype=float).reshape(-1))
    b = np.nan_to_num(np.asarray(b, dtype=float).reshape(-1))
    na, nb = np.linalg.norm(a), np.linalg.norm(b)
    if na == 0 or nb == 0:
        return 0.0
    return float(a @ b / (na * nb))


# -- NMS / culling ---------------------------------------------------------------


def nms_fast(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
             target_count: Optional[int] = None) -> List[int]:
    """Greedy box NMS keeping up to ``target_count`` boxes."""
    if len(boxes) == 0:
        return []
    order = np.argsort(-np.asarray(scores))
    keep = []
    suppressed = np.zeros(len(boxes), dtype=bool)
    for i in order:
        if suppressed[i]:
            continue
        keep.append(int(i))
        if target_count is not None and len(keep) >= target_count:
            break
        for j in order:
            if j == i or suppressed[j]:
                continue
            if compute_iou(boxes[i], boxes[j]) > iou_threshold:
                suppressed[j] = True
    return keep


def cull_frame_instances(
    instances: List[PredictedInstance],
    target_count: int,
    iou_threshold: float = 0,
) -> List[PredictedInstance]:
    """Reduce a frame's instances to ``target_count``: the top-scoring
    ones, after a bbox NMS when ``iou_threshold`` > 0."""
    if len(instances) <= target_count:
        return instances
    if iou_threshold and iou_threshold > 0:
        boxes = np.array([get_bbox(i) for i in instances])
        scores = np.array([getattr(i, "score", 0.0) for i in instances])
        keep = nms_fast(boxes, scores, iou_threshold, target_count=None)
        instances = [instances[i] for i in keep]
        if len(instances) <= target_count:
            return instances
    order = np.argsort([-getattr(i, "score", 0.0) for i in instances])
    return [instances[i] for i in order[:target_count]]


def cull_instances(labels, target_count: int, iou_threshold: float = 0):
    """Cull every labeled frame's predictions to ``target_count`` in place
    (``cull_frame_instances`` per frame). User instances are never removed."""
    for lf in labels.labeled_frames:
        preds = lf.predicted_instances
        if len(preds) <= target_count:
            continue
        kept = set(map(id, cull_frame_instances(preds, target_count, iou_threshold)))
        lf.instances = [
            i for i in lf.instances
            if not isinstance(i, PredictedInstance) or id(i) in kept
        ]
    return labels
