"""Post-prediction instance filters.

Port of ``sleap_nn_tpu/inference/filters.py``: node-count and confidence
filters and overlapping-instance suppression (greedy bbox-IoU or OKS NMS),
applied to each frame's predicted instances before they become
``LabeledFrame``s. The OKS, IoU and bbox helpers are this module's own
copies of the JAX package's ``evaluation.compute_oks`` and
``tracking.utils.compute_iou`` / ``get_bbox``, which the port has not
ported as modules yet (ROADMAP.md section 1, items 5 and 6).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from sleap_nn_tpu_torch.io.model import PredictedInstance


@dataclasses.dataclass
class FilterConfig:
    """Knobs for the instance filter pipeline."""

    min_node_count: Optional[int] = None
    min_node_confidence: Optional[float] = None
    min_instance_score: Optional[float] = None
    overlap_method: Optional[str] = None  # "iou" | "oks"
    overlap_threshold: float = 0.8
    max_centroid_distance: Optional[float] = None
    min_visible_node_fraction: Optional[float] = None
    min_mean_node_score: Optional[float] = None

    def enabled(self) -> bool:
        return any(
            v is not None
            for v in (
                self.min_node_count,
                self.min_node_confidence,
                self.min_instance_score,
                self.overlap_method,
                self.max_centroid_distance,
                self.min_visible_node_fraction,
                self.min_mean_node_score,
            )
        )


def _bbox(inst) -> np.ndarray:
    pts = inst.numpy()
    return np.array(
        [np.nanmin(pts[:, 0]), np.nanmin(pts[:, 1]), np.nanmax(pts[:, 0]), np.nanmax(pts[:, 1])]
    )


def _iou(a: np.ndarray, b: np.ndarray) -> float:
    """IoU of ``[x0, y0, x1, y1]`` boxes."""
    ax0, ay0, ax1, ay1 = a
    bx0, by0, bx1, by1 = b
    ix0, iy0 = max(ax0, bx0), max(ay0, by0)
    ix1, iy1 = min(ax1, bx1), min(ay1, by1)
    iw, ih = max(0.0, ix1 - ix0), max(0.0, iy1 - iy0)
    inter = iw * ih
    union = (ax1 - ax0) * (ay1 - ay0) + (bx1 - bx0) * (by1 - by0) - inter
    return float(inter / union) if union > 0 else 0.0


def _oks(points_gt: np.ndarray, points_pr: np.ndarray, stddev: float = 0.025) -> float:
    """Object keypoint similarity of two ``(n_nodes, 2)`` instances, with
    cocoeval's normalization and the ground truth's bbox area as scale."""
    area = np.prod(np.nanmax(points_gt, axis=0) - np.nanmin(points_gt, axis=0))
    distance = ((points_gt - points_pr) ** 2).sum(axis=-1)
    norm = (2 * stddev) ** 2 * 2 * (area + np.spacing(1))
    distance = np.where(np.any(np.isnan(points_pr), axis=-1), np.inf, distance)
    missing_gt = np.any(np.isnan(points_gt), axis=-1)
    ks = np.where(missing_gt, 0.0, np.exp(-(distance / norm)))
    return float(np.sum(ks) / np.sum((~missing_gt).astype("float32")))


def apply_node_confidence_filter(
    inst: PredictedInstance, min_confidence: float
) -> PredictedInstance:
    """NaN-out nodes below a confidence floor."""
    low = inst.point_scores < min_confidence
    inst.points[low] = np.nan
    inst.visible = inst.visible & ~low
    return inst


def suppress_overlapping(
    instances: List[PredictedInstance], method: str, threshold: float
) -> List[PredictedInstance]:
    """Greedy NMS over instances by bbox-IoU or OKS, highest score first."""
    if method not in ("iou", "oks"):
        raise ValueError(
            f"Invalid overlap method {method!r}; choose 'iou' or 'oks'."
        )
    order = np.argsort([-i.score for i in instances])
    keep: List[PredictedInstance] = []
    for idx in order:
        cand = instances[idx]
        ok = True
        for kept in keep:
            if method == "iou":
                sim = _iou(_bbox(cand), _bbox(kept))
            else:
                sim = _oks(kept.numpy(), cand.numpy())
            if sim > threshold:
                ok = False
                break
        if ok:
            keep.append(cand)
    return keep


class FilterPipeline:
    """Apply the configured filters to one frame's instances."""

    def __init__(self, config: FilterConfig):
        self.config = config

    def apply(self, instances: List[PredictedInstance]) -> List[PredictedInstance]:
        cfg = self.config
        out = list(instances)
        if cfg.min_node_confidence is not None:
            out = [apply_node_confidence_filter(i, cfg.min_node_confidence) for i in out]
        if cfg.min_node_count is not None:
            out = [i for i in out if i.n_visible >= cfg.min_node_count]
        if cfg.min_visible_node_fraction is not None:
            out = [
                i for i in out
                if i.n_visible >= cfg.min_visible_node_fraction * len(i.points)
            ]
        if cfg.min_mean_node_score is not None:
            out = [
                i for i in out
                if float(np.nanmean(np.where(i.visible, i.point_scores, np.nan)))
                >= cfg.min_mean_node_score
            ]
        if cfg.min_instance_score is not None:
            out = [i for i in out if i.score >= cfg.min_instance_score]
        if cfg.overlap_method is not None and len(out) > 1:
            out = suppress_overlapping(out, cfg.overlap_method, cfg.overlap_threshold)
        if cfg.max_centroid_distance is not None and len(out) > 1:
            # Drop lower-scoring instances whose centroid lies within the
            # distance of a higher-scoring one (duplicate detections).
            order = np.argsort([-i.score for i in out])
            keep = []
            for idx in order:
                c = np.nanmean(out[idx].numpy(), axis=0)
                if all(
                    np.linalg.norm(c - np.nanmean(k.numpy(), axis=0))
                    > cfg.max_centroid_distance
                    for k in keep
                ):
                    keep.append(out[idx])
            out = keep
        return out
