"""Post-prediction instance filters.

Port of ``sleap_nn_tpu/inference/filters.py``: node-count and confidence
filters and overlapping-instance suppression (greedy bbox-IoU or OKS NMS),
applied to each frame's predicted instances before they become
``LabeledFrame``s.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from sleap_nn_tpu_torch.evaluation import compute_oks
from sleap_nn_tpu_torch.io.model import PredictedInstance
from sleap_nn_tpu_torch.tracking.utils import compute_iou, get_bbox


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
                sim = compute_iou(get_bbox(cand), get_bbox(kept))
            else:
                sim = compute_oks(kept.numpy()[None], cand.numpy()[None])[0, 0]
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
