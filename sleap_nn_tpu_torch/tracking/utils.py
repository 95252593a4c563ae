"""Tracking utilities: matching, features, scorers, NMS, culling.

Port of ``sleap_nn_tpu/tracking/utils.py``, with the ``"masks"``
feature of segmentation output: ``MaskFeature`` (a mask's foreground
bounding-box crop, origin, area and mask-to-image scale), ``get_mask``,
``is_segmentation_mask``, the mask area as the support count of
``count_valid_points`` and the ``mask_iou`` score ``compute_mask_iou``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
from scipy.optimize import linear_sum_assignment

from sleap_nn_tpu_torch.evaluation import compute_oks
from sleap_nn_tpu_torch.io.model import PredictedInstance


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
    """A mask's foreground bounding-box crop, its origin ``(y0, x0)`` on the
    mask's grid, its area and ``scale`` (mask px -> image px). IoU of two
    such features touches only the overlap of their boxes."""

    __slots__ = ("crop", "y0", "x0", "area", "scale")

    def __init__(self, crop: np.ndarray, y0: int, x0: int, area: int, scale: float = 1.0):
        self.crop = crop
        self.y0 = int(y0)
        self.x0 = int(x0)
        self.area = int(area)
        self.scale = float(scale)

    def rescaled(self, target_scale: float) -> "MaskFeature":
        """This feature on a finer grid (cv2 nearest neighbour)."""
        if self.scale == target_scale or self.area == 0:
            return MaskFeature(self.crop, self.y0, self.x0, self.area, target_scale)
        import cv2

        f = self.scale / float(target_scale)
        h = max(1, int(round(self.crop.shape[0] * f)))
        w = max(1, int(round(self.crop.shape[1] * f)))
        crop = cv2.resize(self.crop.astype(np.uint8), (w, h),
                          interpolation=cv2.INTER_NEAREST).astype(bool)
        return MaskFeature(crop, int(round(self.y0 * f)), int(round(self.x0 * f)),
                           int(np.count_nonzero(crop)), target_scale)


def _mask_feature_from_dense(data: np.ndarray, scale: float = 1.0) -> MaskFeature:
    data = np.ascontiguousarray(data, dtype=bool)
    rows = np.any(data, axis=1)
    if not rows.any():
        return MaskFeature(np.zeros((0, 0), dtype=bool), 0, 0, 0, scale)
    cols = np.any(data, axis=0)
    y0 = int(np.argmax(rows))
    y1 = len(rows) - int(np.argmax(rows[::-1]))
    x0 = int(np.argmax(cols))
    x1 = len(cols) - int(np.argmax(cols[::-1]))
    crop = data[y0:y1, x0:x1]
    return MaskFeature(crop, y0, x0, int(np.count_nonzero(crop)), scale)


def get_mask(obj) -> MaskFeature:
    """The ``"masks"`` feature of a ``SegmentationMask`` or a bool array."""
    if isinstance(obj, MaskFeature):
        return obj
    if isinstance(obj, np.ndarray):
        return _mask_feature_from_dense(obj)
    data = getattr(obj, "mask", None)
    if data is None:
        raise TypeError(f"Cannot extract a mask feature from {type(obj).__name__}")
    return _mask_feature_from_dense(np.asarray(data, dtype=bool),
                                    scale=float(getattr(obj, "scale", 1.0) or 1.0))


def is_segmentation_mask(obj) -> bool:
    """True for a ``SegmentationMask`` or a ``MaskFeature``."""
    return isinstance(obj, MaskFeature) or (hasattr(obj, "mask") and not hasattr(obj, "numpy"))


def count_valid_points(inst) -> int:
    """The number of nodes with both coordinates; for a mask, its area in
    pixels (so ``min_new_track_points`` and ``min_match_points`` are areas
    on the ``"masks"`` feature)."""
    if is_segmentation_mask(inst):
        return get_mask(inst).area
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


def compute_mask_iou(a, b) -> float:
    """Pixel IoU of two masks (the ``mask_iou`` score), over the overlap of
    their boxes: both empty gives 1, one empty 0. Masks of different
    scales compare on the finer grid."""
    fa = a if isinstance(a, MaskFeature) else get_mask(a)
    fb = b if isinstance(b, MaskFeature) else get_mask(b)
    if fa.area == 0 or fb.area == 0:
        return 1.0 if fa.area == fb.area else 0.0
    if fa.scale != fb.scale:
        fine = min(fa.scale, fb.scale)
        fa, fb = fa.rescaled(fine), fb.rescaled(fine)
    ay1, ax1 = fa.y0 + fa.crop.shape[0], fa.x0 + fa.crop.shape[1]
    by1, bx1 = fb.y0 + fb.crop.shape[0], fb.x0 + fb.crop.shape[1]
    oy0, oy1 = max(fa.y0, fb.y0), min(ay1, by1)
    ox0, ox1 = max(fa.x0, fb.x0), min(ax1, bx1)
    inter = 0
    if oy1 > oy0 and ox1 > ox0:
        ca = fa.crop[oy0 - fa.y0:oy1 - fa.y0, ox0 - fa.x0:ox1 - fa.x0]
        cb = fb.crop[oy0 - fb.y0:oy1 - fb.y0, ox0 - fb.x0:ox1 - fb.x0]
        inter = int(np.count_nonzero(ca & cb))
    union = fa.area + fb.area - inter
    return float(inter / union) if union else 1.0


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
