"""Evaluation metrics: OKS, PCK, VOC mAP/mAR, distances, visibility, masks.

Port of ``sleap_nn_tpu/evaluation.py``: ``compute_oks`` (cocoeval
normalization), greedy score-ranked instance matching, VOC
precision/recall interpolation, PCK and distance percentiles, the
centroid match mode, the mask match modes (``mask``: Hungarian IoU
matching of each frame's masks, with boundary IoU, clDice, panoptic
quality, over- and under-segmentation counts, size buckets and COCO-style
mask AP; ``semantic``: the whole-frame foreground IoU), ``run_evaluation``
and the npz metrics file (which each package's ``load_metrics`` reads
from the other). Host numpy (and ``scipy.ndimage`` for the boundary
bands and skeletons), as in the JAX package, with the same dtypes: OKS
counts visible nodes in float32 and every ranking sort is a mergesort.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels

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
        vi = labels_pr.videos.index(lf.video) if lf.video in labels_pr.videos else 0
        pr_index[(vi, lf.frame_idx)] = lf

    for lf_gt in labels_gt.labeled_frames:
        vi = labels_gt.videos.index(lf_gt.video) if lf_gt.video in labels_gt.videos else 0
        frame_gt = lf_gt
        if user_labels_only:
            user = lf_gt.user_instances
            if not user and not lf_gt.masks:
                continue
            frame_gt = LabeledFrame(lf_gt.video, lf_gt.frame_idx, user, masks=lf_gt.masks)
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
# Mask and semantic metrics
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


def _decode_frame_masks(frame) -> list:
    """A frame's masks decoded to IMAGE resolution (by each mask's scale).

    Stride-encoded masks (``SegmentationMask.scale != 1``) are nearest-
    upsampled; plain arrays / scale-1 masks pass through untouched.
    """
    out = []
    for m in getattr(frame, "masks", []) or []:
        if hasattr(m, "decode"):
            out.append(m.decode())
        else:
            out.append(np.asarray(getattr(m, "mask", m), bool))
    return out


def _pad_mask_to(m: np.ndarray, h: int, w: int) -> np.ndarray:
    """Zero-pad (bottom/right) to a common canvas; no-op when already there."""
    if m.shape == (h, w):
        return m
    out = np.zeros((h, w), dtype=bool)
    hh, ww = min(h, m.shape[0]), min(w, m.shape[1])
    out[:hh, :ww] = m[:hh, :ww]
    return out


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    """Pixel IoU of two binary masks."""
    a = np.asarray(a, bool)
    b = np.asarray(b, bool)
    union = np.logical_or(a, b).sum()
    if union == 0:
        return 0.0
    return float(np.logical_and(a, b).sum() / union)


def match_masks(gt_masks, pr_masks, iou_threshold: float = 0.5):
    """Hungarian IoU matching of masks.

    Returns (pairs [(gt_i, pr_j, iou)], fn_inds, fp_inds)."""
    from scipy.optimize import linear_sum_assignment

    if not gt_masks or not pr_masks:
        return [], list(range(len(gt_masks))), list(range(len(pr_masks)))
    iou = np.array([[mask_iou(g, p) for p in pr_masks] for g in gt_masks])
    rows, cols = linear_sum_assignment(-iou)
    pairs, used_g, used_p = [], set(), set()
    for r, c in zip(rows, cols):
        if iou[r, c] >= iou_threshold:
            pairs.append((int(r), int(c), float(iou[r, c])))
            used_g.add(int(r))
            used_p.add(int(c))
    fn = [i for i in range(len(gt_masks)) if i not in used_g]
    fp = [j for j in range(len(pr_masks)) if j not in used_p]
    return pairs, fn, fp


def _mask_to_boundary(mask: np.ndarray, dilation_ratio: float = 0.02) -> np.ndarray:
    """Boundary band of a mask."""
    from scipy import ndimage

    mask = np.asarray(mask, bool)
    h, w = mask.shape
    d = max(1, int(round(dilation_ratio * np.hypot(h, w))))
    eroded = ndimage.binary_erosion(mask, iterations=d)
    return mask & ~eroded


def boundary_iou(gt: np.ndarray, pr: np.ndarray, dilation_ratio: float = 0.02) -> float:
    """IoU restricted to boundary bands."""
    return mask_iou(_mask_to_boundary(gt, dilation_ratio), _mask_to_boundary(pr, dilation_ratio))


def _skeletonize(mask: np.ndarray, max_iters: int = 128) -> np.ndarray:
    """Morphological skeleton via iterative erosion-opening (scipy-only
    stand-in for skimage.skeletonize)."""
    from scipy import ndimage

    mask = np.asarray(mask, bool)
    skel = np.zeros_like(mask)
    m = mask.copy()
    for _ in range(max_iters):
        if not m.any():
            break
        eroded = ndimage.binary_erosion(m)
        opened = ndimage.binary_dilation(eroded)
        skel |= m & ~opened
        m = eroded
    return skel


def mask_cldice(pred: np.ndarray, gt: np.ndarray) -> float:
    """Centerline Dice (clDice) for thin structures."""
    pred = np.asarray(pred, bool)
    gt = np.asarray(gt, bool)
    if not pred.any() or not gt.any():
        return 0.0
    sp = _skeletonize(pred)
    sg = _skeletonize(gt)
    tprec = (sp & gt).sum() / max(sp.sum(), 1)
    tsens = (sg & pred).sum() / max(sg.sum(), 1)
    if tprec + tsens == 0:
        return 0.0
    return float(2 * tprec * tsens / (tprec + tsens))


# ---------------------------------------------------------------------------
# Evaluator
# ---------------------------------------------------------------------------


class Evaluator:
    """Standard pose metrics from GT and predicted labels.

    ``match_method``: ``"oks"`` (greedy score-ranked OKS matching),
    ``"centroid"`` (Hungarian centroid pairing under ``match_threshold``
    px, 50 when 0), ``"mask"`` (Hungarian IoU matching of each frame's
    masks at ``match_threshold``, 0.5 when 0) or ``"semantic"`` (each
    frame's union of masks against the ground truth's).
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
        elif match_method in ("mask", "semantic"):
            self._process_frames_mask()
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

    def _process_frames_mask(self):
        """Pair GT/pred masks per frame (mask and semantic modes)."""
        iou_thr = self.match_threshold if self.match_threshold > 0 else 0.5
        self.positive_pairs, self.false_negatives = [], []
        self.mask_pairs = []  # (gt_mask, pr_mask, iou)
        self.semantic_frames = []  # (gt_union, pr_union)
        self._mask_frames = []  # per-frame IoU/score/area payloads
        for frame_gt, frame_pr in self.frame_pairs:
            # Scale-aware compare. Uniform-scale frames (the common
            # case: full-res GT vs full-res preds, or a stride-encoded
            # retrack against stride-encoded pseudo-labels) compare at their
            # NATIVE resolution — nearest upsampling by a common factor
            # leaves IoU unchanged and costs stride^2 in memory/compute.
            # Mixed scales decode to image pixels first. Either way, areas
            # and intersections are reported in IMAGE px^2 (``area_unit``)
            # so cross-frame size buckets stay consistent.
            gt_scales = [float(getattr(m, "scale", 1.0) or 1.0)
                         for m in getattr(frame_gt, "masks", []) or []]
            pr_scales = [float(getattr(m, "scale", 1.0) or 1.0)
                         for m in getattr(frame_pr, "masks", []) or []]
            uniform = len({round(s, 6) for s in gt_scales + pr_scales}) <= 1
            if uniform:
                s = (gt_scales + pr_scales + [1.0])[0]
                area_unit = s * s
                gt_masks = [np.asarray(m.mask if hasattr(m, "mask") else m, bool)
                            for m in getattr(frame_gt, "masks", []) or []]
                pr_masks = [np.asarray(m.mask if hasattr(m, "mask") else m, bool)
                            for m in getattr(frame_pr, "masks", []) or []]
            else:
                area_unit = 1.0
                gt_masks = _decode_frame_masks(frame_gt)
                pr_masks = _decode_frame_masks(frame_pr)
            if gt_masks or pr_masks:
                # Pad to one canvas so a smaller-extent mask never crops the
                # other side to its top-left corner.
                hh = max(m.shape[0] for m in gt_masks + pr_masks)
                ww = max(m.shape[1] for m in gt_masks + pr_masks)
                gt_masks = [_pad_mask_to(m, hh, ww) for m in gt_masks]
                pr_masks = [_pad_mask_to(m, hh, ww) for m in pr_masks]
            if self.match_method == "semantic":
                def union(ms, like):
                    if ms:
                        out = np.zeros_like(ms[0], dtype=bool)
                        for m in ms:
                            out |= m
                        return out
                    return np.zeros_like(like, dtype=bool) if like is not None else None

                g = union(gt_masks, pr_masks[0] if pr_masks else None)
                p = union(pr_masks, gt_masks[0] if gt_masks else None)
                if g is not None and p is not None:
                    self.semantic_frames.append((g, p))
                continue
            pairs, fn, fp = match_masks(gt_masks, pr_masks, iou_thr)
            # Per-frame payload for PQ / per-size / fragmentation / COCO mAP:
            # the 1-to-1 Hungarian pairs above can't express those
            #. One pixel pass per pair
            # computes intersection; IoU derives from it and the areas (no
            # second full-canvas mask_iou sweep).
            n_p, n_g = len(pr_masks), len(gt_masks)
            pr_areas = np.array([int(m.sum()) for m in pr_masks], dtype=float)
            gt_areas_arr = np.array([int(m.sum()) for m in gt_masks], dtype=float)
            iou_mat = np.zeros((n_p, n_g), dtype=float)
            inter_mat = np.zeros((n_p, n_g), dtype=float)
            for pj in range(n_p):
                for gi in range(n_g):
                    a, b = pr_masks[pj], gt_masks[gi]
                    hh = min(a.shape[0], b.shape[0])
                    ww = min(a.shape[1], b.shape[1])
                    inter = float(np.logical_and(a[:hh, :ww], b[:hh, :ww]).sum())
                    inter_mat[pj, gi] = inter
                    union = pr_areas[pj] + gt_areas_arr[gi] - inter
                    iou_mat[pj, gi] = inter / union if union > 0 else 0.0
            # Report areas/intersections in IMAGE pixel units regardless of
            # the resolution compared at (IoU is unit-free).
            pr_areas = pr_areas * area_unit
            gt_areas_arr = gt_areas_arr * area_unit
            inter_mat = inter_mat * area_unit
            self._mask_frames.append(
                {
                    "iou": iou_mat,
                    "inter": inter_mat,
                    "pred_scores": np.array(
                        [float(getattr(m, "score", 0.0) or 0.0) for m in frame_pr.masks],
                        dtype=float,
                    ),
                    "gt_areas": gt_areas_arr,
                    "pred_areas": pr_areas,
                }
            )
            gt_mi = get_instances(frame_gt)
            for (gi, pj, iou) in pairs:
                self.mask_pairs.append((gt_masks[gi], pr_masks[pj], iou))
                self.positive_pairs.append(
                    (
                        MatchInstance(frame_gt.masks[gi], frame_gt.frame_idx),
                        MatchInstance(frame_pr.masks[pj], frame_pr.frame_idx),
                        iou,
                    )
                )
            self.false_negatives.extend(
                MatchInstance(frame_gt.masks[i], frame_gt.frame_idx) for i in fn
            )
            self.false_positives.extend(
                MatchInstance(frame_pr.masks[j], frame_pr.frame_idx) for j in fp
            )
        self.dists_dict = {"dists": np.zeros((0, 1)), "frame_idxs": [], "video_paths": []}

    def mask_metrics(self) -> dict:
        """Matched-mask quality + PQ + fragmentation + per-size.

        ``pq = sq * rq`` with ``sq`` = TP-only mean IoU and
        ``rq = TP / (TP + 0.5*FP + 0.5*FN)`` (Kirillov et al. 2019);
        ``per_size`` buckets GT masks by area under the dataset-relative
        percentile scheme (primary) and the fixed COCO cutoffs (additional).
        """
        ious = np.array([iou for _, _, iou in self.mask_pairs])
        bious = np.array(
            [boundary_iou(g, p) for g, p, _ in self.mask_pairs]
        ) if self.mask_pairs else np.array([])
        cld = np.array(
            [mask_cldice(p, g) for g, p, _ in self.mask_pairs]
        ) if self.mask_pairs else np.array([])
        n_tp = len(self.mask_pairs)
        n_fp = len(self.false_positives)
        n_fn = len(self.false_negatives)
        over, under = self._fragmentation_counts()
        results = {
            "mean_iou": float(ious.mean()) if ious.size else np.nan,
            "min": float(ious.min()) if ious.size else np.nan,
            "max": float(ious.max()) if ious.size else np.nan,
            "mean_boundary_iou": float(bious.mean()) if bious.size else np.nan,
            "mean_cldice": float(cld.mean()) if cld.size else np.nan,
            "mean_iou_all_gt": np.nan,
            "pq": np.nan,
            "sq": np.nan,
            "rq": np.nan,
            "oversegmentation": over,
            "undersegmentation": under,
            "per_size": self._mask_per_size_stats(),
            "n_matched": n_tp,
            "n_fp": n_fp,
            "n_fn": n_fn,
            "ious": ious,
        }
        for ptile in (25, 50, 75):
            results[f"p{ptile}"] = (
                float(np.percentile(ious, ptile)) if ious.size else np.nan
            )
        iou_sum = float(ious.sum()) if ious.size else 0.0
        if n_tp + n_fn > 0:
            results["mean_iou_all_gt"] = iou_sum / (n_tp + n_fn)
        pq_denom = n_tp + 0.5 * n_fp + 0.5 * n_fn
        if pq_denom > 0:
            results["sq"] = results["mean_iou"]
            results["rq"] = n_tp / pq_denom
            results["pq"] = iou_sum / pq_denom
        return results

    def _fragmentation_counts(self, overlap_frac: float = 0.1) -> Tuple[int, int]:
        """Over-/under-segmentation counts.

        Over: GT masks covered (>= ``overlap_frac`` of GT area) by >= 2
        predictions. Under: predictions covering >= 2 GT masks.
        """
        over = under = 0
        for f in getattr(self, "_mask_frames", []):
            inter, gt_areas = f["inter"], f["gt_areas"]
            if inter.size == 0:
                continue
            covers = inter >= (overlap_frac * np.maximum(gt_areas, 1.0))[None, :]
            over += int(np.count_nonzero(covers.sum(axis=0) >= 2))
            under += int(np.count_nonzero(covers.sum(axis=1) >= 2))
        return over, under

    def _mask_per_size_stats(self) -> dict:
        """Per-object-size GT/TP/IoU breakdown."""
        gt_areas_all = np.array(
            [a for f in getattr(self, "_mask_frames", []) for a in f["gt_areas"]],
            dtype=float,
        )
        tp_iou = np.array([iou for _, _, iou in self.mask_pairs], dtype=float)
        tp_gt_area = np.array(
            [int(g.sum()) for g, _, _ in self.mask_pairs], dtype=float
        )

        def breakdown(edges):
            out = {}
            for i, bucket in enumerate(_SIZE_KEYS):
                in_gt = _size_mask(gt_areas_all, i, edges)
                in_tp = _size_mask(tp_gt_area, i, edges)
                out[bucket] = {
                    "n_gt": int(np.count_nonzero(in_gt)),
                    "n_tp": int(np.count_nonzero(in_tp)),
                    "mean_iou": (
                        float(tp_iou[in_tp].mean()) if np.any(in_tp) else np.nan
                    ),
                }
            return out

        out = breakdown(_percentile_size_edges(gt_areas_all))
        out["scheme"] = "percentile"
        out["coco"] = breakdown(COCO_SIZE_EDGES)
        return out

    def _match_masks_coco(self, iou_threshold: float):
        """Greedy score-ranked pred->GT matching per frame (pycocotools style).

        Returns flat aligned arrays ``(scores, matched, matched_gt_area,
        pred_area)`` over every prediction.
        """
        scores, matched, matched_gt_area, pred_area = [], [], [], []
        for f in getattr(self, "_mask_frames", []):
            iou = f["iou"]
            n_pred, n_gt = iou.shape
            order = (
                np.argsort(-f["pred_scores"], kind="mergesort")
                if n_pred
                else np.array([], dtype=int)
            )
            gt_taken = np.zeros(n_gt, dtype=bool)
            for p in order:
                scores.append(float(f["pred_scores"][p]))
                pred_area.append(float(f["pred_areas"][p]))
                if n_gt == 0:
                    matched.append(False)
                    matched_gt_area.append(np.nan)
                    continue
                row = iou[p].copy()
                row[gt_taken] = -1.0
                g = int(np.argmax(row))
                if row[g] >= iou_threshold:
                    gt_taken[g] = True
                    matched.append(True)
                    matched_gt_area.append(float(f["gt_areas"][g]))
                else:
                    matched.append(False)
                    matched_gt_area.append(np.nan)
        return (
            np.array(scores, dtype=float),
            np.array(matched, dtype=bool),
            np.array(matched_gt_area, dtype=float),
            np.array(pred_area, dtype=float),
        )

    def mask_voc_metrics(
        self,
        iou_thresholds: np.ndarray = None,
        recall_thresholds: np.ndarray = None,
        size_percentiles: Tuple[float, float] = (100 / 3.0, 200 / 3.0),
    ) -> dict:
        """COCO-style mask AP/AR with dual per-size breakdowns.

        Predictions are re-matched at each IoU threshold with greedy
        score-ranked matching, the PR curve is 101-point interpolated, and
        per-size APs follow pycocotools ``areaRng`` semantics (out-of-bucket
        GT is ignored: TPs filter on matched-GT area, FPs on their own area).
        """
        if iou_thresholds is None:
            iou_thresholds = np.linspace(0.5, 0.95, 10)
        if recall_thresholds is None:
            recall_thresholds = np.linspace(0, 1, 101)
        iou_thresholds = np.asarray(iou_thresholds, dtype=float)
        gt_areas_all = np.array(
            [a for f in getattr(self, "_mask_frames", []) for a in f["gt_areas"]],
            dtype=float,
        )
        npig = int(gt_areas_all.size)
        schemes = {
            "percentile": _percentile_size_edges(gt_areas_all, size_percentiles),
            "coco": COCO_SIZE_EDGES,
        }
        n_gt_size = {
            name: [
                int(np.count_nonzero(_size_mask(gt_areas_all, i, edges)))
                for i in range(len(_SIZE_KEYS))
            ]
            for name, edges in schemes.items()
        }
        ap_overall = np.full(iou_thresholds.size, np.nan)
        recall_overall = np.full(iou_thresholds.size, np.nan)
        ap_size = {
            name: [np.full(iou_thresholds.size, np.nan) for _ in _SIZE_KEYS]
            for name in schemes
        }
        for ti, thr in enumerate(iou_thresholds):
            scores, matched, matched_gt_area, pred_area = self._match_masks_coco(
                float(thr)
            )
            ap_overall[ti], recall_overall[ti] = _ap_from_pr(
                scores, matched, npig, recall_thresholds
            )
            for name, edges in schemes.items():
                for i in range(len(_SIZE_KEYS)):
                    keep_tp = matched & _size_mask(matched_gt_area, i, edges)
                    keep_fp = (~matched) & _size_mask(pred_area, i, edges)
                    keep = keep_tp | keep_fp
                    ap_size[name][i][ti], _ = _ap_from_pr(
                        scores[keep], keep_tp[keep], n_gt_size[name][i],
                        recall_thresholds,
                    )

        def _nanmean(arr):
            return float(np.nanmean(arr)) if np.any(~np.isnan(arr)) else np.nan

        def _at(target):
            return float(ap_overall[int(np.argmin(np.abs(iou_thresholds - target)))])

        results = {
            "mask_voc.iou_thresholds": iou_thresholds,
            "mask_voc.AP": ap_overall,
            "mask_voc.recalls": recall_overall,
            "mask_voc.mAP": _nanmean(ap_overall),
            "mask_voc.AR": _nanmean(recall_overall),
            "mask_voc.AP50": _at(0.5),
            "mask_voc.AP75": _at(0.75),
            "mask_voc.n_gt": npig,
            "mask_voc.size_scheme": "percentile",
            "mask_voc.size_edges": [float(e) for e in schemes["percentile"]],
            "mask_voc.coco.size_edges": [float(e) for e in schemes["coco"]],
        }
        for name, prefix in (("percentile", "mask_voc."), ("coco", "mask_voc.coco.")):
            for i, bucket in enumerate(_SIZE_KEYS):
                results[f"{prefix}AP_{bucket}"] = _nanmean(ap_size[name][i])
                results[f"{prefix}n_gt_{bucket}"] = n_gt_size[name][i]
        return results

    def semantic_metrics(self) -> dict:
        """Matching-free whole-frame foreground metrics."""
        if not getattr(self, "semantic_frames", None):
            return {"fg_iou": np.nan, "boundary_iou": np.nan, "cldice": np.nan}
        ious = [mask_iou(g, p) for g, p in self.semantic_frames]
        bious = [boundary_iou(g, p) for g, p in self.semantic_frames]
        cld = [mask_cldice(p, g) for g, p in self.semantic_frames]
        return {
            "fg_iou": float(np.mean(ious)),
            "boundary_iou": float(np.mean(bious)),
            "cldice": float(np.mean(cld)),
            "n_frames": len(self.semantic_frames),
        }

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
        if self.match_method == "mask":
            return {
                "detection_metrics": self.detection_metrics(),
                "mask_metrics": self.mask_metrics(),
                "mask_voc_metrics": self.mask_voc_metrics(),
            }
        if self.match_method == "semantic":
            return {"semantic_metrics": self.semantic_metrics()}
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
    prediction (for ``mask`` and ``semantic``, no mask); ``match_method="auto"``
    picks ``centroid`` for a one-node skeleton, else ``oks``."""
    from sleap_nn_tpu_torch.io.slp import load_slp

    labels_gt = ground_truth_path if isinstance(ground_truth_path, Labels) else load_slp(
        ground_truth_path
    )
    labels_pr = predicted_path if isinstance(predicted_path, Labels) else load_slp(
        predicted_path
    )

    if match_method in ("mask", "semantic"):
        has_predictions = any(len(lf.masks) for lf in labels_pr)
    else:
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
