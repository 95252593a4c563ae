"""Evaluation metrics: OKS, PCK, VOC mAP/mAR, distances, visibility.

Port of the pose and centroid half of ``sleap_nn_tpu/evaluation.py``:
``compute_oks`` (cocoeval normalization), greedy score-ranked instance
matching, VOC precision/recall interpolation, PCK and distance
percentiles, the centroid match mode, ``run_evaluation`` and the npz
metrics file (which each package's ``load_metrics`` reads from the
other). Host numpy, as in the JAX package, with the same dtypes: OKS
counts visible nodes in float32 and every ranking sort is a mergesort.

The mask half waits for ``SegmentationMask`` (ROADMAP.md section 1, item
10): the mask functions, the ``mask`` and ``semantic`` match methods and
labels that carry masks raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels

_MASKS = "mask evaluation needs SegmentationMask, which is not ported (ROADMAP.md section 1, item 10)"


def _refuse_masks(what: str):
    raise NotImplementedError(f"{what}: {_MASKS}")


# ---------------------------------------------------------------------------
# Core math
# ---------------------------------------------------------------------------


def compute_instance_area(points: np.ndarray) -> np.ndarray:
    """Bounding-box area of keypoint sets."""
    if points.ndim == 2:
        points = np.expand_dims(points, axis=0)
    min_pt = np.nanmin(points, axis=-2)
    max_pt = np.nanmax(points, axis=-2)
    return np.prod(max_pt - min_pt, axis=-1)


def compute_oks(
    points_gt: np.ndarray,
    points_pr: np.ndarray,
    scale: Optional[float] = None,
    stddev: float = 0.025,
    use_cocoeval: bool = True,
) -> np.ndarray:
    """Object keypoint similarity matrix ``(n_gt, n_pr)``.

    cocoeval normalization by default: spread ``(2*stddev)**2``, scale
    ``2*(area+eps)``.
    """
    if points_gt.ndim == 2:
        points_gt = np.expand_dims(points_gt, axis=0)
    if points_pr.ndim == 2:
        points_pr = np.expand_dims(points_pr, axis=0)
    if scale is None:
        scale = compute_instance_area(points_gt)

    n_gt, n_nodes, n_ed = points_gt.shape
    n_pr = points_pr.shape[0]
    if np.isscalar(scale):
        scale = np.full(n_gt, scale)
    if np.isscalar(stddev):
        stddev = np.full(n_nodes, stddev)

    displacement = np.reshape(points_gt, (n_gt, 1, n_nodes, n_ed)) - np.reshape(
        points_pr, (1, n_pr, n_nodes, n_ed)
    )
    distance = (displacement**2).sum(axis=-1)

    if use_cocoeval:
        spread_factor = (2 * stddev) ** 2
        scale_factor = 2 * (scale + np.spacing(1))
    else:
        spread_factor = stddev**2
        scale_factor = 2 * ((scale + np.spacing(1)) ** 2)
    normalization_factor = np.reshape(spread_factor, (1, 1, n_nodes)) * np.reshape(
        scale_factor, (n_gt, 1, 1)
    )

    missing_pr = np.any(np.isnan(points_pr), axis=-1)
    distance = np.where(missing_pr[None, :, :], np.inf, distance)
    ks = np.exp(-(distance / normalization_factor))
    missing_gt = np.any(np.isnan(points_gt), axis=-1)
    # A broadcast mask, not boolean indexing: with n_pr > 1 a boolean index
    # of shape (n_gt, 1, n_nodes) does not align with (n_gt, n_pr, n_nodes).
    ks = np.where(missing_gt[:, None, :], 0.0, ks)
    n_visible_gt = np.sum((~missing_gt).astype("float32"), axis=-1, keepdims=True)
    return np.sum(ks, axis=-1) / n_visible_gt


@dataclasses.dataclass
class MatchInstance:
    """An instance and the frame it came from."""

    instance: Any
    frame_idx: int
    video_path: Optional[str] = None


def get_instances(lf: LabeledFrame) -> List[MatchInstance]:
    vpath = str(getattr(lf.video, "filename", "")) if lf.video is not None else ""
    return [MatchInstance(inst, lf.frame_idx, vpath) for inst in lf.instances]


def find_frame_pairs(
    labels_gt: Labels, labels_pr: Labels, user_labels_only: bool = True
) -> List[Tuple[LabeledFrame, LabeledFrame]]:
    """Pair GT and predicted frames by (video position, frame_idx)."""
    pairs = []
    pr_index: Dict[Tuple[int, int], LabeledFrame] = {}
    for lf in labels_pr.labeled_frames:
        if getattr(lf, "masks", None):
            _refuse_masks("predicted labels with masks")
        vi = labels_pr.videos.index(lf.video) if lf.video in labels_pr.videos else 0
        pr_index[(vi, lf.frame_idx)] = lf

    for lf_gt in labels_gt.labeled_frames:
        if getattr(lf_gt, "masks", None):
            _refuse_masks("ground-truth labels with masks")
        vi = labels_gt.videos.index(lf_gt.video) if lf_gt.video in labels_gt.videos else 0
        frame_gt = lf_gt
        if user_labels_only:
            user = lf_gt.user_instances
            if not user:
                continue
            frame_gt = LabeledFrame(lf_gt.video, lf_gt.frame_idx, user)
        lf_pr = pr_index.get((vi, lf_gt.frame_idx))
        if lf_pr is not None:
            pairs.append((frame_gt, lf_pr))
    return pairs


def match_instances(
    frame_gt: LabeledFrame,
    frame_pr: LabeledFrame,
    stddev: float = 0.025,
    scale: Optional[float] = None,
    threshold: float = 0,
):
    """Greedy score-ranked OKS matching within one frame."""
    pr_instances = get_instances(frame_pr)
    scores_pr = np.array(
        [getattr(m.instance, "score", 0.0) for m in pr_instances], dtype=float
    )
    idxs_pr = np.argsort(-scores_pr, kind="mergesort")

    available_gt = get_instances(frame_gt)
    available_idxs = list(range(len(available_gt)))

    positive_pairs = []
    for idx_pr in idxs_pr:
        if not available_idxs:
            break
        instance_pr = pr_instances[idx_pr]
        points_pr = np.expand_dims(instance_pr.instance.numpy(), axis=0)
        points_gt = np.stack(
            [available_gt[i].instance.numpy() for i in available_idxs], axis=0
        )
        oks = np.squeeze(
            compute_oks(points_gt, points_pr, stddev=stddev, scale=scale), axis=1
        )
        oks[oks <= threshold] = np.nan
        best = int(np.argsort(-oks, kind="mergesort")[0])
        if np.isnan(oks[best]):
            continue
        gt_idx = available_idxs.pop(best)
        positive_pairs.append((available_gt[gt_idx], instance_pr, float(oks[best])))

    false_negatives = [available_gt[i] for i in available_idxs]
    return positive_pairs, false_negatives


def match_frame_pairs(frame_pairs, stddev=0.025, scale=None, threshold=0):
    """Match instances over a list of frame pairs."""
    positive_pairs, false_negatives = [], []
    for frame_gt, frame_pr in frame_pairs:
        pp, fn = match_instances(frame_gt, frame_pr, stddev, scale, threshold)
        positive_pairs.extend(pp)
        false_negatives.extend(fn)
    return positive_pairs, false_negatives


def compute_dists(positive_pairs) -> Dict[str, Any]:
    """Per-node Euclidean errors of matched pairs."""
    dists, frame_idxs, video_paths = [], [], []
    for gt, pr, _ in positive_pairs:
        dists.append(
            np.linalg.norm(pr.instance.numpy() - gt.instance.numpy(), axis=-1)
        )
        frame_idxs.append(gt.frame_idx)
        video_paths.append(gt.video_path)
    return {
        "dists": np.array(dists),
        "frame_idxs": frame_idxs,
        "video_paths": video_paths,
    }


# ---------------------------------------------------------------------------
# Centroid matching (single-node / centroid-only models)
# ---------------------------------------------------------------------------


def compute_gt_centroids(labels: Labels, anchor_part: Optional[str] = None):
    """GT centroid per instance (the anchor node when visible, else the mean)."""
    out = {}
    for lf in labels.labeled_frames:
        cents = []
        for inst in lf.user_instances or lf.instances:
            cents.append(inst.centroid(anchor=anchor_part))
        out[(id(lf.video), lf.frame_idx)] = np.array(cents)
    return out


def match_centroids(gt_pts: np.ndarray, pr_pts: np.ndarray, threshold: float = 50.0):
    """Optimal (Hungarian) centroid pairing under a pixel threshold."""
    from scipy.optimize import linear_sum_assignment

    if len(gt_pts) == 0 or len(pr_pts) == 0:
        return [], list(range(len(gt_pts))), list(range(len(pr_pts)))
    d = np.linalg.norm(gt_pts[:, None] - pr_pts[None, :], axis=-1)
    d_safe = np.where(np.isnan(d), 1e9, d)
    rows, cols = linear_sum_assignment(d_safe)
    pairs, used_gt, used_pr = [], set(), set()
    for r, c in zip(rows, cols):
        if d_safe[r, c] <= threshold:
            pairs.append((int(r), int(c), float(d[r, c])))
            used_gt.add(int(r))
            used_pr.add(int(c))
    fn = [i for i in range(len(gt_pts)) if i not in used_gt]
    fp = [i for i in range(len(pr_pts)) if i not in used_pr]
    return pairs, fn, fp


# ---------------------------------------------------------------------------
# Size buckets and AP (shared with the mask metrics of item 10)
# ---------------------------------------------------------------------------


# COCO object-size area cutoffs (px^2): small < 32^2 <= medium < 96^2 <= large.
COCO_SIZE_EDGES = np.array([32.0**2, 96.0**2])
_SIZE_KEYS = ("small", "medium", "large")


def _percentile_size_edges(gt_areas, percentiles=(100 / 3.0, 200 / 3.0)) -> np.ndarray:
    """Dataset-relative size-bucket edges: percentiles of the GT areas."""
    g = np.asarray(gt_areas, dtype=float)
    g = g[~np.isnan(g)]
    if g.size == 0:
        return np.array([np.nan, np.nan])
    return np.percentile(g, percentiles)


def _size_mask(areas, bucket_idx: int, edges) -> np.ndarray:
    """Select areas in size bucket ``bucket_idx`` (NaN excluded everywhere)."""
    areas = np.asarray(areas, dtype=float)
    lo = -np.inf if bucket_idx == 0 else edges[bucket_idx - 1]
    hi = np.inf if bucket_idx >= len(edges) else edges[bucket_idx]
    with np.errstate(invalid="ignore"):
        return (areas >= lo) & (areas < hi)


def _ap_from_pr(scores, matched, n_gt, recall_thresholds) -> Tuple[float, float]:
    """101-point-interpolated AP and final recall from score-ranked TP flags."""
    if n_gt == 0:
        return np.nan, np.nan
    if scores.size == 0:
        return 0.0, 0.0
    order = np.argsort(-scores, kind="mergesort")
    tp = np.cumsum(matched[order])
    fp = np.cumsum(~matched[order])
    rc = tp / n_gt
    pr = tp / (tp + fp + np.spacing(1))
    recall = float(rc[-1])
    for i in range(pr.size - 1, 0, -1):
        if pr[i] > pr[i - 1]:
            pr[i - 1] = pr[i]
    inds = np.searchsorted(rc, recall_thresholds, side="left")
    precision = np.zeros(inds.shape)
    valid = inds < pr.size
    precision[valid] = pr[inds[valid]]
    return float(precision.mean()), recall


def mask_iou(a, b) -> float:
    _refuse_masks("mask_iou")


def match_masks(gt_masks, pr_masks, iou_threshold: float = 0.5):
    _refuse_masks("match_masks")


def boundary_iou(gt, pr, dilation_ratio: float = 0.02) -> float:
    _refuse_masks("boundary_iou")


def mask_cldice(pred, gt) -> float:
    _refuse_masks("mask_cldice")


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


class Evaluator:
    """Standard pose metrics from GT and predicted labels.

    ``match_method``: ``"oks"`` (greedy score-ranked OKS matching) or
    ``"centroid"`` (Hungarian centroid pairing under ``match_threshold``
    px, 50 when 0); ``"mask"`` and ``"semantic"`` raise (item 10).
    """

    def __init__(
        self,
        ground_truth_instances: Labels,
        predicted_instances: Labels,
        oks_stddev: float = 0.025,
        oks_scale: Optional[float] = None,
        match_threshold: float = 0,
        user_labels_only: bool = True,
        match_method: str = "oks",
        anchor_part: Optional[str] = None,
    ):
        if match_method in ("mask", "semantic"):
            _refuse_masks(f"match_method={match_method!r}")
        self.labels_gt = ground_truth_instances
        self.labels_pr = predicted_instances
        self.oks_stddev = oks_stddev
        self.oks_scale = oks_scale
        self.match_threshold = match_threshold
        self.match_method = match_method
        self.anchor_part = anchor_part
        self.false_positives: List = []

        self.frame_pairs = find_frame_pairs(
            self.labels_gt, self.labels_pr, user_labels_only
        )
        if match_method == "centroid":
            self._process_frames_centroid()
        else:
            self._process_frames()

    def _process_frames(self):
        self.positive_pairs, self.false_negatives = match_frame_pairs(
            self.frame_pairs,
            stddev=self.oks_stddev,
            scale=self.oks_scale,
            threshold=self.match_threshold,
        )
        matched_pr = {id(pr.instance) for _, pr, _ in self.positive_pairs}
        for _, frame_pr in self.frame_pairs:
            for inst in frame_pr.instances:
                if id(inst) not in matched_pr:
                    self.false_positives.append(inst)
        self.dists_dict = compute_dists(self.positive_pairs)

    def _process_frames_centroid(self):
        threshold = self.match_threshold if self.match_threshold > 0 else 50.0
        self.positive_pairs, self.false_negatives = [], []
        dists = []
        for frame_gt, frame_pr in self.frame_pairs:
            gt_c = np.array(
                [inst.centroid(anchor=self.anchor_part) for inst in frame_gt.instances]
            )
            pr_c = np.array(
                [np.nanmean(inst.numpy(), axis=0) for inst in frame_pr.instances]
            )
            pairs, fn, fp = match_centroids(
                gt_c.reshape(-1, 2) if gt_c.size else gt_c,
                pr_c.reshape(-1, 2) if pr_c.size else pr_c,
                threshold,
            )
            gt_mi = get_instances(frame_gt)
            pr_mi = get_instances(frame_pr)
            for r, c, d in pairs:
                self.positive_pairs.append((gt_mi[r], pr_mi[c], d))
                dists.append([d])
            self.false_negatives.extend(gt_mi[i] for i in fn)
            self.false_positives.extend(pr_mi[i] for i in fp)
        self.dists_dict = {
            "dists": np.array(dists) if dists else np.zeros((0, 1)),
            "frame_idxs": [p[0].frame_idx for p in self.positive_pairs],
            "video_paths": [p[0].video_path for p in self.positive_pairs],
        }

    def mask_metrics(self) -> dict:
        _refuse_masks("mask_metrics")

    def mask_voc_metrics(self, iou_thresholds=None, recall_thresholds=None,
                         size_percentiles=(100 / 3.0, 200 / 3.0)) -> dict:
        _refuse_masks("mask_voc_metrics")

    def semantic_metrics(self) -> dict:
        _refuse_masks("semantic_metrics")

    # -- metrics ---------------------------------------------------------------
    def mOKS(self):
        pair_oks = np.array([oks for _, _, oks in self.positive_pairs])
        return {"mOKS": float(pair_oks.mean()) if pair_oks.size else np.nan}

    def voc_metrics(
        self,
        match_score_by: str = "oks",
        match_score_thresholds: np.ndarray = np.linspace(0.5, 0.95, 10),
        recall_thresholds: np.ndarray = np.linspace(0, 1, 101),
    ) -> dict:
        """PASCAL-VOC style AP/AR over match-score thresholds."""
        if match_score_by == "oks":
            match_scores = np.array([oks for _, _, oks in self.positive_pairs])
            name = "oks_voc"
        elif match_score_by == "pck":
            name = "pck_voc"
            if not self.positive_pairs:
                match_scores = np.array([])
            else:
                pck = self.pck_metrics()
                match_scores = pck["pcks"].mean(axis=-1).mean(axis=-1)
        else:
            raise ValueError("match_score_by must be 'oks' or 'pck'")

        detection_scores = np.array(
            [getattr(pp[1].instance, "score", 0.0) for pp in self.positive_pairs]
        )
        inds = np.argsort(-detection_scores, kind="mergesort")
        detection_scores = detection_scores[inds]
        match_scores = match_scores[inds] if match_scores.size else match_scores

        npig = len(self.positive_pairs) + len(self.false_negatives)
        precisions, recalls = [], []
        for thr in match_score_thresholds:
            tp = np.cumsum(match_scores >= thr)
            fp = np.cumsum(match_scores < thr)
            if tp.size == 0:
                return {
                    f"{name}.match_score_thresholds": 0,
                    f"{name}.recall_thresholds": 0,
                    f"{name}.match_scores": 0,
                    f"{name}.precisions": 0,
                    f"{name}.recalls": 0,
                    f"{name}.AP": 0,
                    f"{name}.AR": 0,
                    f"{name}.mAP": 0,
                    f"{name}.mAR": 0,
                }
            rc = tp / npig if npig else tp * 0.0
            pr = tp / (fp + tp + np.spacing(1))
            recall = rc[-1]
            for i in range(len(pr) - 1, 0, -1):
                if pr[i] > pr[i - 1]:
                    pr[i - 1] = pr[i]
            rc_inds = np.searchsorted(rc, recall_thresholds, side="left")
            precision = np.zeros(rc_inds.shape)
            valid = rc_inds < len(pr)
            precision[valid] = pr[rc_inds[valid]]
            precisions.append(precision)
            recalls.append(recall)

        precisions = np.array(precisions)
        recalls = np.array(recalls)
        AP = precisions.mean(axis=1)
        AR = recalls
        return {
            f"{name}.match_score_thresholds": match_score_thresholds,
            f"{name}.recall_thresholds": recall_thresholds,
            f"{name}.match_scores": match_scores,
            f"{name}.precisions": precisions,
            f"{name}.recalls": recalls,
            f"{name}.AP": AP,
            f"{name}.AR": AR,
            f"{name}.mAP": float(AP.mean()),
            f"{name}.mAR": float(AR.mean()),
        }

    def distance_metrics(self) -> dict:
        dists = self.dists_dict["dists"]
        results = {
            "frame_idxs": self.dists_dict["frame_idxs"],
            "video_paths": self.dists_dict["video_paths"],
            "dists": dists,
            "avg": (
                float(np.nanmean(dists))
                if np.asarray(dists).size and not np.all(np.isnan(dists))
                else np.nan
            ),
            "p50": np.nan,
            "p75": np.nan,
            "p90": np.nan,
            "p95": np.nan,
            "p99": np.nan,
        }
        non_nan = ~np.isnan(dists) if np.asarray(dists).size else np.array([], dtype=bool)
        if np.any(non_nan):
            vals = dists[non_nan]
            for p in (50, 75, 90, 95, 99):
                results[f"p{p}"] = float(np.percentile(vals, p))
        return results

    def detection_metrics(self) -> dict:
        n_tp = len(self.positive_pairs)
        n_fp = len(self.false_positives)
        n_fn = len(self.false_negatives)
        precision = n_tp / (n_tp + n_fp) if (n_tp + n_fp) else 0.0
        recall = n_tp / (n_tp + n_fn) if (n_tp + n_fn) else 0.0
        f1 = 2 * precision * recall / (precision + recall) if (precision + recall) else 0.0
        results = {
            "precision": precision,
            "recall": recall,
            "f1": f1,
            "n_tp": n_tp,
            "n_fp": n_fp,
            "n_fn": n_fn,
            "avg": np.nan,
            "p50": np.nan,
            "p75": np.nan,
            "p90": np.nan,
            "p95": np.nan,
            "p99": np.nan,
        }
        dists = self.dists_dict["dists"]
        non_nan = ~np.isnan(dists) if np.asarray(dists).size else np.array([], dtype=bool)
        if np.any(non_nan):
            vals = dists[non_nan]
            results["avg"] = float(np.mean(vals))
            for p in (50, 75, 90, 95, 99):
                results[f"p{p}"] = float(np.percentile(vals, p))
        return results

    def pck_metrics(self, thresholds: np.ndarray = np.linspace(1, 10, 10)) -> dict:
        dists = np.copy(self.dists_dict["dists"])
        dists[np.isnan(dists)] = np.inf
        pcks = np.expand_dims(dists, -1) < np.reshape(thresholds, (1, 1, -1))
        if dists.size == 0:
            return {
                "thresholds": thresholds,
                "pcks": pcks,
                "mPCK_parts": np.array([]),
                "mPCK": np.nan,
                "PCK@5": np.nan,
                "PCK@10": np.nan,
            }
        mPCK_parts = pcks.mean(axis=0).mean(axis=-1)
        idx5 = int(np.argmin(np.abs(thresholds - 5)))
        idx10 = int(np.argmin(np.abs(thresholds - 10)))
        return {
            "thresholds": thresholds,
            "pcks": pcks,
            "mPCK_parts": mPCK_parts,
            "mPCK": float(mPCK_parts.mean()),
            "PCK@5": float(pcks[:, :, idx5].mean()),
            "PCK@10": float(pcks[:, :, idx10].mean()),
        }

    def visibility_metrics(self) -> dict:
        tp = fn = fp = tn = 0
        for gt, pr, _ in self.positive_pairs:
            miss_gt = np.isnan(gt.instance.numpy()).any(axis=-1)
            miss_pr = np.isnan(pr.instance.numpy()).any(axis=-1)
            tn += (miss_gt & miss_pr).sum()
            fn += (~miss_gt & miss_pr).sum()
            fp += (miss_gt & ~miss_pr).sum()
            tp += (~miss_gt & ~miss_pr).sum()
        return {
            "tp": int(tp),
            "fp": int(fp),
            "tn": int(tn),
            "fn": int(fn),
            "precision": tp / (tp + fp) if (tp + fp) else np.nan,
            "recall": tp / (tp + fn) if (tp + fn) else np.nan,
        }

    def evaluate(self) -> dict:
        if self.match_method == "centroid":
            return {
                "detection_metrics": self.detection_metrics(),
                "distance_metrics": self.distance_metrics(),
            }
        metrics = {}
        metrics["voc_metrics"] = self.voc_metrics(match_score_by="oks")
        metrics["voc_metrics"].update(self.voc_metrics(match_score_by="pck"))
        metrics["mOKS"] = self.mOKS()
        metrics["distance_metrics"] = self.distance_metrics()
        metrics["pck_metrics"] = self.pck_metrics()
        metrics["visibility_metrics"] = self.visibility_metrics()
        return metrics


# ---------------------------------------------------------------------------
# Entry and persistence
# ---------------------------------------------------------------------------


def _is_single_node_skeleton(skeleton) -> bool:
    return skeleton is not None and len(skeleton.node_names) == 1


def run_evaluation(
    ground_truth_path,
    predicted_path,
    oks_stddev: float = 0.025,
    oks_scale: Optional[float] = None,
    match_threshold: float = 0,
    user_labels_only: bool = True,
    save_metrics: Optional[str] = None,
    match_method: str = "oks",
    anchor_part: Optional[str] = None,
) -> Optional[dict]:
    """Evaluate predictions against ground truth, each a ``Labels`` or a
    ``.slp`` path (read by ``load_slp``). Returns None when there is no
    prediction; ``match_method="auto"`` picks ``centroid`` for a one-node
    skeleton, else ``oks``."""
    if match_method in ("mask", "semantic"):
        _refuse_masks(f"match_method={match_method!r}")
    from sleap_nn_tpu_torch.io.slp import load_slp

    labels_gt = ground_truth_path if isinstance(ground_truth_path, Labels) else load_slp(
        ground_truth_path
    )
    labels_pr = predicted_path if isinstance(predicted_path, Labels) else load_slp(
        predicted_path
    )

    has_predictions = any(len(lf.instances) for lf in labels_pr)
    if not len(labels_pr) or not has_predictions:
        return None

    pred_skel = labels_pr.skeletons[0] if labels_pr.skeletons else None
    if match_method == "auto":
        match_method = "centroid" if _is_single_node_skeleton(pred_skel) else "oks"
    if match_method == "centroid" and match_threshold == 0:
        match_threshold = 50.0

    evaluator = Evaluator(
        labels_gt,
        labels_pr,
        oks_stddev=oks_stddev,
        oks_scale=oks_scale,
        match_threshold=match_threshold,
        user_labels_only=user_labels_only,
        match_method=match_method,
        anchor_part=anchor_part,
    )
    metrics = evaluator.evaluate()
    if save_metrics:
        save_metrics_npz(metrics, save_metrics)
    return metrics


def _flatten(metrics: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in metrics.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}.{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _json_safe(obj):
    """Recursively convert metrics to JSON-serializable values (NaN and
    infinities become None)."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, np.ndarray):
        return _json_safe(obj.tolist())
    if isinstance(obj, np.generic):
        obj = obj.item()  # fall through: NaN/Inf scalars must become null
    if isinstance(obj, float) and not np.isfinite(obj):
        return None
    return obj


#: Keys pruned from the .json sibling (kept in the npz): bulk per-pair
#: arrays that dominate the JSON and that the metrics UI does not read.
_JSON_PRUNE_KEYS = frozenset(
    {"pcks", "dists", "oks_matrix", "per_pair", "all_pcks"}
)


def _prune_json_bloat(obj):
    """Drop bulk array keys from a (nested) metrics dict for the JSON sibling."""
    if isinstance(obj, dict):
        return {
            k: _prune_json_bloat(v)
            for k, v in obj.items()
            if k not in _JSON_PRUNE_KEYS
        }
    return obj


def save_metrics_npz(metrics: dict, path):
    """Save metrics as an npz (one compressed pickled dict under the
    ``metrics`` key; ``load_metrics`` synthesizes the flat dotted keys on
    read) plus a ``.json`` sibling for tools that do not unpickle, with the
    bulk per-pair arrays pruned from the JSON only."""
    import json

    np.savez_compressed(path, metrics=np.asarray(metrics, dtype=object))
    try:
        Path(path).with_suffix(".json").write_text(
            json.dumps(_json_safe(_prune_json_bloat(metrics)), indent=2)
        )
    except (TypeError, ValueError, OSError):
        pass  # the npz is the source of truth; the json sibling is best-effort


def _find_metrics_file(model_dir: Path, split: str, dataset_idx: int) -> Path:
    """The metrics file of a model dir: ``metrics.{split}.{idx}.npz``, then
    ``{split}_{idx}_pred_metrics.npz``, then ``metrics.{split}_{idx}.npz``;
    a ``test`` split with none of them falls back to ``val``."""
    for name in (
        f"metrics.{split}.{dataset_idx}.npz",
        f"{split}_{dataset_idx}_pred_metrics.npz",
        f"metrics.{split}_{dataset_idx}.npz",
    ):
        p = model_dir / name
        if p.exists():
            return p
    if split == "test":
        return _find_metrics_file(model_dir, "val", dataset_idx)
    return model_dir / f"metrics.{split}.{dataset_idx}.npz"


def load_metrics(path, split: str = "test", dataset_idx: int = 0) -> dict:
    """Load metrics from a model dir or an npz file.

    Accepts a model directory (``split`` / ``dataset_idx`` select the file,
    ``test`` falling back to ``val``) or an ``.npz`` path, in any of three
    formats: one pickled ``metrics`` dict, per-group pickled dicts, or flat
    dotted keys. The returned dict supports both ``m["mOKS"]["mOKS"]`` and
    ``m["mOKS.mOKS"]``.
    """
    p = Path(path)
    if p.suffix != ".npz":
        p = _find_metrics_file(p, split, dataset_idx)
    if not p.exists():
        raise FileNotFoundError(f"Metrics file not found at {p}")
    with np.load(p, allow_pickle=True) as data:
        if "metrics" in data.files:
            nested = data["metrics"].item()
            return {**_flatten(nested), **nested}
        out = {}
        for k in data.files:
            v = data[k]
            if v.dtype == object and v.shape == ():
                # per-group pickled sub-dicts
                item = v.item()
                out[k] = item
                if isinstance(item, dict):
                    out.update(_flatten({k: item}))
            else:
                out[k] = v
        return out
