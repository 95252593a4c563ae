"""Segmentation inference: centre peaks, offset grouping, masks.

Port of ``sleap_nn_tpu/inference/segmentation.py``: the bottom-up
segmentation layer (foreground, instance-centre and centre-offset heads;
centre peaks through ``ops/peaks.find_local_peaks``, so the NMS kernel on
the card, with the ``center_nms_kernel`` window; each foreground pixel
joins the nearest detected centre that its offset votes for, in plain
torch as the JAX package does it in plain jnp), the semantic layer (one
foreground mask per frame) and the top-down layer (a centroid model, then
a ``centered_instance_segmentation`` model on fixed-size crops). Each
layer follows ``layers.InferenceLayer``: ``forward`` is the device step,
``postprocess_host`` the host step on the fetched numpy (mask clean-up
with ``scipy.ndimage``, the optional fragment merge, resizes and pastes
with cv2 nearest neighbour), which yields the ``SegmentationMask`` lists
(``pred_masks``) that ``Predictor.to_labels`` consumes.

The fragment merge (a region adjacency graph over touching candidate
masks, scored by the centre heatmap's ridge between their centres and by
the agreement of their offset votes, then a greedy or a multicut
agglomeration) is host numpy, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sleap_nn_tpu_torch.inference.layers import (
    CentroidLayer,
    InferenceLayer,
    preprocess_images,
)
from sleap_nn_tpu_torch.io.model import SegmentationMask
from sleap_nn_tpu_torch.ops.crops import crop_bboxes, make_centered_bboxes
from sleap_nn_tpu_torch.ops.peaks import find_local_peaks


def find_center_peaks(center_heatmap: torch.Tensor, threshold: float = 0.2,
                      max_peaks: int = 50, nms_kernel: int = 3):
    """Instance-centre detections on ``(B, H, W, 1)`` centre heatmaps:
    local peaks (odd ``nms_kernel`` window; above 3 merges nearby
    duplicates) with integral refinement. Returns ``(centers (B, K, 2),
    vals (B, K), valid (B, K))`` in heatmap grid coordinates."""
    points, vals, _, valid = find_local_peaks(
        center_heatmap, threshold=threshold, refinement="integral",
        max_peaks=max_peaks, nms_kernel=nms_kernel)
    return points, vals, valid


def group_instances_from_offsets(
    fg_mask: torch.Tensor,
    offsets: torch.Tensor,
    centers: torch.Tensor,
    centers_valid: torch.Tensor,
    output_stride: int = 2,
    max_center_dist: float = 64.0,
    fg_threshold: float = 0.5,
    distance_gate_alpha: Optional[float] = None,
) -> torch.Tensor:
    """Assign each foreground pixel to the centre its offset votes for.

    A pixel at grid cell ``(i, j)`` sits at ``(j * s + s / 2, i * s + s /
    2)`` and votes ``pixel + offset``; it joins the nearest valid centre
    (the first on a tie, as ``argmin`` takes it in both libraries) within
    ``max_center_dist`` px. With ``distance_gate_alpha``, a second pass
    drops pixels whose vote lies more than ``alpha * sqrt(area / pi)``
    from their centre (``area`` in pixels of the centres' space).

    Args:
        fg_mask: ``(B, H, W, 1)`` probabilities or binary.
        offsets: ``(B, H, W, 2)`` ``(dx, dy)`` in the centres' pixels.
        centers: ``(B, K, 2)``; ``centers_valid`` ``(B, K)``.

    Returns:
        ``(B, K, H, W)`` bool instance masks at grid resolution.
    """
    b, h, w, _ = fg_mask.shape
    dev = fg_mask.device
    xx = torch.arange(w, dtype=torch.float32, device=dev) * output_stride + output_stride / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev) * output_stride + output_stride / 2.0
    voted_x = xx[None, None, :] + offsets[..., 0]
    voted_y = yy[None, :, None] + offsets[..., 1]  # (B, H, W)
    dx = voted_x[:, None] - centers[..., 0][:, :, None, None]  # (B, K, H, W)
    dy = voted_y[:, None] - centers[..., 1][:, :, None, None]
    d2 = dx**2 + dy**2
    del dx, dy
    d2 = torch.where(centers_valid[:, :, None, None], d2, float("inf"))
    nearest = torch.argmin(d2, dim=1)  # (B, H, W); all-inf gives 0, as jnp
    near_d2 = torch.amin(d2, dim=1)
    fg = fg_mask[..., 0] > fg_threshold
    ok = fg & (near_d2 <= max_center_dist**2)
    k = centers.shape[1]
    inst = (nearest[:, None] == torch.arange(k, device=dev)[None, :, None, None]) & ok[:, None]
    if distance_gate_alpha is not None:
        area_px = inst.sum(dim=(2, 3)).float() * float(output_stride) ** 2
        r2 = (float(distance_gate_alpha) ** 2) * area_px / math.pi  # (B, K)
        inst = inst & (d2 <= r2[:, :, None, None])
    return inst


def _disk_structure(radius: int) -> np.ndarray:
    """Disk structuring element of the given pixel radius."""
    yy, xx = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    return (xx * xx + yy * yy) <= radius * radius


def mask_cleanup(mask: np.ndarray, min_area: int = 16, radius: int = 0,
                 fill_holes: bool = False) -> np.ndarray:
    """The largest connected component of ``mask``, empty if smaller than
    ``min_area``. ``radius`` > 0 first opens then closes with a disk of
    that radius; ``fill_holes`` fills the kept component's holes."""
    from scipy import ndimage

    if radius > 0 and mask.any():
        st = _disk_structure(int(radius))
        mask = ndimage.binary_opening(mask, structure=st)
        mask = ndimage.binary_closing(mask, structure=st)
    labeled, n = ndimage.label(mask)
    if n == 0:
        return np.zeros_like(mask, dtype=bool)
    sizes = ndimage.sum(mask, labeled, index=np.arange(1, n + 1))
    best = int(np.argmax(sizes)) + 1
    out = labeled == best
    if fill_holes:
        out = ndimage.binary_fill_holes(out)
    if out.sum() < min_area:
        return np.zeros_like(mask, dtype=bool)
    return out


def mask_to_polygon(mask: np.ndarray, epsilon_frac: float = 0.01,
                    scale: float = 1.0) -> Optional[np.ndarray]:
    """Outline ``(N, 2)`` ``(x, y)`` of a bool mask's largest external
    contour (cv2), simplified by Douglas-Peucker with a tolerance of
    ``epsilon_frac`` times its perimeter (0: not simplified) and multiplied
    by ``scale`` (mask px -> image px). None for an empty or degenerate
    mask."""
    import cv2

    contours, _ = cv2.findContours(np.ascontiguousarray(mask, dtype=np.uint8),
                                   cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
    if not contours:
        return None
    cnt = max(contours, key=cv2.contourArea)
    if epsilon_frac > 0:
        eps = float(epsilon_frac) * cv2.arcLength(cnt, True)
        cnt = cv2.approxPolyDP(cnt, eps, True)
    if len(cnt) < 3:
        return None
    return cnt.reshape(-1, 2).astype(np.float64) * float(scale)


def upsample_mask(mask: np.ndarray, output_stride: int, out_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour upsample of a grid mask, cropped to ``out_hw``."""
    up = np.repeat(np.repeat(mask, output_stride, axis=0), output_stride, axis=1)
    return up[: out_hw[0], : out_hw[1]]


def crop_valid_grid(mask: np.ndarray, orig_hw, eff_scale: float, scale: float,
                    stride: int) -> np.ndarray:
    """A grid mask cut to the cells that cover the image: the grid spans the
    scaled input's padding to the max stride (and the sizematcher's), so
    it keeps ``ceil(round(round(orig * eff) * scale) / stride)`` rows and
    columns."""
    h, w = (int(v) for v in np.asarray(orig_hw).reshape(-1)[:2])
    sh = int(round(h * eff_scale))
    sw = int(round(w * eff_scale))
    gh = -(-int(round(sh * scale)) // stride)
    gw = -(-int(round(sw * scale)) // stride)
    return mask[:gh, :gw]


def _first(value) -> float:
    return float(np.asarray(value).reshape(-1)[0])


def _resize_nearest(mask: np.ndarray, wh: Tuple[int, int]) -> np.ndarray:
    import cv2

    return cv2.resize(mask.astype(np.uint8), wh, interpolation=cv2.INTER_NEAREST).astype(bool)


class BottomUpSegmentationLayer(InferenceLayer):
    """Foreground, centres and offsets -> instance masks.

    Device (:meth:`forward`): preprocess, the model, centre peaks (at most
    ``max_instances``), the offset grouping into ``(B, K, H, W)`` masks.
    Host (:meth:`postprocess_host`): a centre counts only where its mask
    keeps at least ``area_floor`` grid cells (``min_mask_area`` is in
    original pixels: ``max(1, ceil(min_mask_area / lift**2))`` with
    ``lift`` the grid-to-original factor); the fragment merge
    (``merge_fragments``); the clean-up (``mask_cleanup``, with hole
    filling); with ``full_res_masks`` a resize to the original frame.
    Masks stay on the grid otherwise, their ``scale`` the grid-to-original
    factor.
    """

    def __init__(self, backend, pre, post, seg_output_stride=2, center_output_stride=2,
                 offsets_output_stride=2, max_center_dist=64.0, min_mask_area=0,
                 max_instances: int = 50, merge_fragments: bool = False,
                 merge_method: str = "greedy", fg_threshold: float = 0.5,
                 center_nms_kernel: int = 3, distance_gate_alpha: Optional[float] = None,
                 mask_cleanup: bool = True, mask_cleanup_radius: int = 0,
                 merge_dilate: int = 1, merge_w_valley: float = 1.0,
                 merge_w_offset: float = 0.25,
                 merge_thresholds: Sequence[float] = (0.85, 0.6, 0.4),
                 full_res_masks: bool = False, device="cuda"):
        super().__init__(backend, pre, post, device)
        self.seg_output_stride = seg_output_stride
        self.center_output_stride = center_output_stride
        self.offsets_output_stride = offsets_output_stride
        self.max_center_dist = max_center_dist
        self.min_mask_area = min_mask_area
        self.max_instances = max_instances
        self.merge_fragments = bool(merge_fragments)
        self.merge_method = merge_method
        self.fg_threshold = fg_threshold
        self.center_nms_kernel = center_nms_kernel
        self.distance_gate_alpha = distance_gate_alpha
        self.do_mask_cleanup = bool(mask_cleanup)
        self.mask_cleanup_radius = int(mask_cleanup_radius)
        self.merge_dilate = int(merge_dilate)
        self.merge_w_valley = float(merge_w_valley)
        self.merge_w_offset = float(merge_w_offset)
        self.merge_thresholds = tuple(merge_thresholds)
        self.full_res_masks = bool(full_res_masks)

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        x, eff_scale = preprocess_images(self.pre, images)
        preds = self.backend(x)
        fg = preds["SegmentationHead"]
        centers_hm = preds["InstanceCenterHead"]
        offsets = preds["CenterOffsetHead"]
        pts, vals, valid = find_center_peaks(
            centers_hm, threshold=self.post.peak_threshold, max_peaks=self.max_instances,
            nms_kernel=self.center_nms_kernel)
        centers_px = pts * self.center_output_stride  # scaled-image pixels
        inst = group_instances_from_offsets(
            fg, offsets, centers_px, valid, output_stride=self.seg_output_stride,
            max_center_dist=self.max_center_dist, fg_threshold=self.fg_threshold,
            distance_gate_alpha=self.distance_gate_alpha)
        out = {
            "instance_masks": inst,
            "fg": fg,
            "centers": centers_px / (self.pre.scale * eff_scale),
            "center_vals": vals,
            "center_valid": valid,
            "eff_scale": eff_scale,
            "orig_hw": np.array(images.shape[1:3], np.int32),
        }
        if self.merge_fragments:  # the merge's inputs, only where it runs
            out["centers_scaled"] = centers_px
            out["center_heatmap"] = centers_hm[..., 0]
            out["offsets"] = offsets
        return out

    def postprocess_host(self, host: Dict[str, Any]) -> Dict[str, Any]:
        b, k = host["instance_masks"].shape[:2]
        valid = np.asarray(host["center_valid"], bool).copy()
        # A grid cell spans grid_lift original pixels.
        grid_lift = self.seg_output_stride / (self.pre.scale * _first(host["eff_scale"]))
        area_floor = max(1, int(np.ceil(self.min_mask_area / (grid_lift ** 2))))
        lift = 1.0 if self.full_res_masks else grid_lift
        out_masks: List[List[SegmentationMask]] = []
        for i in range(b):
            cands = []
            for j in range(k):
                if not valid[i, j]:
                    continue
                m = np.asarray(host["instance_masks"][i, j], bool)
                if m.sum() < area_floor:
                    valid[i, j] = False
                    continue
                cands.append({
                    "mask": m,
                    "center": (tuple(np.asarray(host["centers_scaled"][i, j]))
                               if self.merge_fragments else (0.0, 0.0)),
                    "score": float(host["center_vals"][i, j]),
                })
            if self.merge_fragments and len(cands) >= 2:
                cands = merge_instances(
                    cands, np.asarray(host["center_heatmap"][i]), np.asarray(host["offsets"][i]),
                    self.seg_output_stride, method=self.merge_method,
                    dilate_iters=self.merge_dilate, w_valley=self.merge_w_valley,
                    w_offset=self.merge_w_offset, thresholds=self.merge_thresholds)
            frame_masks = []
            for c in cands:
                if self.do_mask_cleanup:
                    m = mask_cleanup(c["mask"], area_floor, radius=self.mask_cleanup_radius,
                                     fill_holes=True)
                else:
                    m = c["mask"] if c["mask"].sum() >= area_floor else None
                if m is None or not m.any():
                    continue
                if self.full_res_masks:
                    m = self._to_full_res(m, host)
                frame_masks.append(SegmentationMask(m, score=c["score"], scale=lift))
            out_masks.append(frame_masks)
        return {
            "pred_masks": out_masks,
            "pred_centroids": host["centers"],
            "centroid_vals": host["center_vals"],
            "centroid_valid": valid,
            "mask_scale": lift,
        }

    def _to_full_res(self, mask: np.ndarray, host: Dict[str, Any]) -> np.ndarray:
        """A grid mask at the original frame's resolution: cut to the cells
        that cover the image, then resized."""
        h, w = (int(v) for v in np.asarray(host["orig_hw"]).reshape(-1)[:2])
        mask = crop_valid_grid(mask, host["orig_hw"], _first(host["eff_scale"]),
                               float(self.pre.scale or 1.0), self.seg_output_stride)
        return _resize_nearest(mask, (w, h))


class SemanticSegmentationLayer(InferenceLayer):
    """One whole-frame foreground mask per frame (``fg > fg_threshold``),
    scored by the frame's mean foreground probability; frames without
    foreground get none. With ``full_res_masks`` the mask is resized to
    the original frame."""

    def __init__(self, backend, pre, post, seg_output_stride=2, fg_threshold: float = 0.5,
                 full_res_masks: bool = False, device="cuda"):
        super().__init__(backend, pre, post, device)
        self.seg_output_stride = seg_output_stride
        self.fg_threshold = fg_threshold
        self.full_res_masks = bool(full_res_masks)

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        x, eff_scale = preprocess_images(self.pre, images)
        return {"fg": self.backend(x)["SegmentationHead"], "eff_scale": eff_scale,
                "orig_hw": np.array(images.shape[1:3], np.int32)}

    def postprocess_host(self, host: Dict[str, Any]) -> Dict[str, Any]:
        fg = host["fg"][..., 0] > self.fg_threshold
        eff = _first(host["eff_scale"])
        scale = float(self.pre.scale or 1.0)
        if self.full_res_masks:
            h, w = (int(v) for v in np.asarray(host["orig_hw"]).reshape(-1)[:2])
            fg = np.stack([_resize_nearest(crop_valid_grid(
                f, host["orig_hw"], eff, scale, int(self.seg_output_stride or 1)), (w, h))
                for f in fg])
        lift = 1.0 if self.full_res_masks else self.seg_output_stride / (self.pre.scale * eff)
        return {
            "pred_masks": [
                [SegmentationMask(fg[i], score=float(host["fg"][i].mean()), scale=lift)]
                if fg[i].any() else []
                for i in range(fg.shape[0])
            ],
            "fg_probs": host["fg"],
            "mask_scale": lift,
        }


class TopDownSegmentationLayer(InferenceLayer):
    """Centroids, then a ``centered_instance_segmentation`` model on
    fixed-size crops.

    Device (:meth:`forward`): the centroid layer (at most
    ``max_instances`` centroids), the crops of ``crop_size`` around them
    in the segmentation model's scaled frame, the model on the crop batch
    ``(B * K, crop, crop, C)``, ``probs = sigmoid(SegmentationHead)`` and
    ``masks = probs > fg_threshold``. The head's output is a probability
    already, so ``probs`` is a second sigmoid and lies in (0.5, 0.731), as
    in the JAX package (ROADMAP.md section 3). A crop's score is the mean
    of ``probs`` over its mask (0 where empty). Host
    (:meth:`postprocess_host`): each valid crop's mask resized to the crop's
    span in the original frame and pasted at ``round(top_left / s)``, then
    ``mask_cleanup`` with ``min_mask_area``; masks at image resolution.
    """

    def __init__(self, centroid_layer: CentroidLayer, seg_backend, seg_pre,
                 seg_output_stride: int = 2, fg_threshold: float = 0.5,
                 max_instances: int = 20, crop_size: int = 160, min_mask_area: int = 0,
                 device="cuda"):
        super().__init__(seg_backend, seg_pre, centroid_layer.post, device)
        if centroid_layer.device != self.device:
            raise ValueError(f"stage layer runs on {centroid_layer.device}, layer on "
                             f"{self.device}")
        self.centroid_layer = centroid_layer
        self.seg_output_stride = seg_output_stride
        self.fg_threshold = fg_threshold
        self.max_instances = max_instances
        self.crop_size = crop_size
        self.min_mask_area = min_mask_area

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        c, k, crop = self.centroid_layer, self.max_instances, self.crop_size
        x, eff = preprocess_images(c.pre, images)
        cres = c.forward_preprocessed(x, eff)
        x2, eff2 = (x, eff) if self.pre == c.pre else preprocess_images(self.pre, images)
        ratio = (self.pre.scale * eff2) / (c.pre.scale * cres["eff_scale"])
        cent2 = torch.nan_to_num(cres["centroids_scaled"][:, :k] * ratio, nan=-1e6)
        b, kk = cent2.shape[:2]
        flat_c = cent2.reshape(b * kk, 2)
        bboxes = make_centered_bboxes(flat_c, crop, crop)
        sample_inds = torch.arange(b, device=self.device).repeat_interleave(kk)
        crops = crop_bboxes(x2, bboxes, sample_inds, crop, crop)
        probs = torch.sigmoid(self.backend(crops)["SegmentationHead"][..., 0])  # (b*k, h, w)
        masks = probs > self.fg_threshold
        denom = torch.clamp(masks.sum(dim=(1, 2)).float(), min=1.0)
        scores = torch.where(masks.any(dim=(1, 2)), (probs * masks).sum(dim=(1, 2)) / denom,
                             torch.zeros_like(denom))
        # The crop's integer top-left, as crop_bboxes takes it (truncated).
        half = crop // 2
        top_left = torch.trunc(flat_c - (crop - 1) / 2.0 + half) - half
        h = masks.shape[1]
        return {
            "crop_masks": masks.reshape(b, kk, h, h),
            "crop_scores": scores.reshape(b, kk),
            "top_left": top_left.reshape(b, kk, 2),
            "valid": cres["centroid_valid"][:, :k],
            "pred_centroids": cres["pred_centroids"][:, :k],
            "centroid_vals": cres["centroid_vals"][:, :k],
            "stage2_scale": self.pre.scale * eff2,
            "orig_hw": np.array(images.shape[1:3], np.int32),
        }

    def postprocess_host(self, host: Dict[str, Any]) -> Dict[str, Any]:
        b, k = host["crop_masks"].shape[:2]
        hh, ww = (int(v) for v in host["orig_hw"])
        s = np.broadcast_to(np.asarray(host["stage2_scale"], np.float64).reshape(-1), (b,))
        out_masks: List[List[SegmentationMask]] = []
        for i in range(b):
            frame_masks = []
            size = max(1, int(round(self.crop_size / float(s[i]))))
            for j in range(k):
                if not host["valid"][i, j] or not host["crop_masks"][i, j].any():
                    continue
                up = _resize_nearest(host["crop_masks"][i, j], (size, size))
                canvas = np.zeros((hh, ww), bool)
                ox = int(round(float(host["top_left"][i, j, 0]) / float(s[i])))
                oy = int(round(float(host["top_left"][i, j, 1]) / float(s[i])))
                y0, x0 = max(0, oy), max(0, ox)
                y1, x1 = min(hh, oy + size), min(ww, ox + size)
                if y1 <= y0 or x1 <= x0:
                    continue
                canvas[y0:y1, x0:x1] = up[y0 - oy:y1 - oy, x0 - ox:x1 - ox]
                canvas = mask_cleanup(canvas, self.min_mask_area)
                if canvas.any():
                    frame_masks.append(
                        SegmentationMask(canvas, score=float(host["crop_scores"][i, j])))
            out_masks.append(frame_masks)
        return {
            "pred_masks": out_masks,
            "pred_centroids": host["pred_centroids"],
            "centroid_vals": host["centroid_vals"],
            "centroid_valid": host["valid"],
        }


# ---------------------------------------------------------------------------
# Fragment merge: a region adjacency graph over the candidate masks of one
# frame, then a greedy or a multicut agglomeration. It mends one animal
# split into adjacent masks by two surviving centre peaks: a touching pair
# is scored by the centre heatmap's ridge between their centres (a deep
# valley means two animals) and by whether both masks' pixels vote for one
# shared centre.
# ---------------------------------------------------------------------------


def mask_predicted_centers(mask: np.ndarray, offsets: np.ndarray,
                           output_stride: int) -> np.ndarray:
    """Offset-voted centre ``(x, y)`` px of every foreground pixel of a grid
    mask (``offsets`` ``(H, W, 2)``; cell centres as the grouping's)."""
    ys, xs = np.nonzero(mask)
    if len(ys) == 0:
        return np.zeros((0, 2), np.float64)
    px = xs * float(output_stride) + output_stride / 2.0
    py = ys * float(output_stride) + output_stride / 2.0
    return np.stack([px + offsets[ys, xs, 0], py + offsets[ys, xs, 1]], axis=1)


def contact_fraction(a: np.ndarray, b: np.ndarray, dilate_iters: int = 1) -> float:
    """Symmetric touch fraction of two disjoint masks (at least one dilation)."""
    from scipy.ndimage import binary_dilation

    iters = max(1, int(dilate_iters))
    da = binary_dilation(a, iterations=iters)
    db = binary_dilation(b, iterations=iters)
    overlap = int((da & b).sum() + (a & db).sum())
    if overlap == 0:
        return 0.0
    return overlap / max(1, min(int(a.sum()), int(b.sum())))


def center_valley_ridge(heatmap: np.ndarray, ca: Tuple[float, float], cb: Tuple[float, float],
                        peak_a: float, peak_b: float, n_samples: int = 48) -> float:
    """Ridge score along the centre line (grid coordinates), on its inner
    70%: about 1 where the heatmap stays high (one body), about 0 where it
    dips to the background (two animals)."""
    h, w = heatmap.shape
    t = np.linspace(0.0, 1.0, n_samples)[int(0.15 * n_samples):int(0.85 * n_samples)]
    if len(t) == 0:
        return 1.0
    xi = np.clip(np.round(ca[0] + (cb[0] - ca[0]) * t).astype(int), 0, w - 1)
    yi = np.clip(np.round(ca[1] + (cb[1] - ca[1]) * t).astype(int), 0, h - 1)
    return float(np.clip(heatmap[yi, xi].min() / max(1e-6, min(peak_a, peak_b)), 0.0, 1.0))


def offset_agreement(pa: np.ndarray, pb: np.ndarray, output_stride: int) -> float:
    """About 1 where both masks' pixels vote for one centre, about 0 a body
    apart."""
    if len(pa) == 0 or len(pb) == 0:
        return 0.0
    sep = float(np.hypot(*(pa.mean(0) - pb.mean(0))))
    spread = float(0.5 * (pa.std(0).mean() + pb.std(0).mean()))
    scale = max(spread, float(output_stride))
    return float(np.exp(-(sep ** 2) / (2.0 * (2.0 * scale) ** 2)))


def build_merge_rag(instances: List[Dict], center_heatmap: np.ndarray, offsets: np.ndarray,
                    output_stride: int, dilate_iters: int = 1, w_valley: float = 1.0,
                    w_offset: float = 0.25, contact_floor: float = 1e-3
                    ) -> Dict[Tuple[int, int], float]:
    """Edges ``(i, j)``, ``i < j``, of the touching pairs -> affinity in [0, 1]:
    ``gate * (w_valley * ridge + w_offset * agree) / (w_valley + w_offset)``,
    the contact gate saturating at a contact of 0.05; with both weights 0
    the affinity is the gate alone."""
    n = len(instances)
    voted = [mask_predicted_centers(i["mask"], offsets, output_stride) for i in instances]
    half = output_stride / 2.0
    edges: Dict[Tuple[int, int], float] = {}
    wsum = w_valley + w_offset
    for i in range(n):
        for j in range(i + 1, n):
            contact = contact_fraction(instances[i]["mask"], instances[j]["mask"], dilate_iters)
            if contact <= contact_floor:
                continue
            gate = min(1.0, contact / 0.05)
            if wsum <= 0:
                edges[(i, j)] = gate
                continue
            # Pixel -> grid, so the sampled line has no half-cell offset.
            ca = tuple((c - half) / output_stride for c in instances[i]["center"])
            cb = tuple((c - half) / output_stride for c in instances[j]["center"])
            ridge = center_valley_ridge(center_heatmap, ca, cb, instances[i]["score"],
                                        instances[j]["score"])
            agree = offset_agreement(voted[i], voted[j], output_stride)
            edges[(i, j)] = float(gate * (w_valley * ridge + w_offset * agree) / wsum)
    return edges


class _UnionFind:
    def __init__(self, n: int):
        self.parent = list(range(n))

    def find(self, x: int) -> int:
        while self.parent[x] != x:
            self.parent[x] = self.parent[self.parent[x]]
            x = self.parent[x]
        return x

    def union(self, a: int, b: int):
        self.parent[self.find(b)] = self.find(a)

    def groups(self, n: int) -> List[set]:
        out: Dict[int, set] = {}
        for i in range(n):
            out.setdefault(self.find(i), set()).add(i)
        return list(out.values())


def _materialize_groups(groups: List[set], instances: List[Dict]) -> List[Dict]:
    """Each group's masks ORed, with its best-scoring member's centre and score."""
    out = []
    for g in groups:
        members = sorted(g)
        best = max(members, key=lambda k: instances[k]["score"])
        mask = np.zeros_like(instances[members[0]]["mask"])
        for k in members:
            mask |= instances[k]["mask"]
        out.append({"mask": mask, "center": instances[best]["center"],
                    "score": instances[best]["score"]})
    return out


def merge_greedy_affinity(instances: List[Dict], edges: Dict[Tuple[int, int], float],
                          thresholds: Sequence[float] = (0.85, 0.6, 0.4)) -> List[Dict]:
    """Greedy agglomeration at decreasing thresholds; a merged node's
    affinity to another is the mean of their edges."""
    n = len(instances)
    uf = _UnionFind(n)
    aff: Dict[Tuple[int, int], List[float]] = {k: [v] for k, v in edges.items()}

    def rekey():
        new: Dict[Tuple[int, int], List[float]] = {}
        for (a, b), vals in aff.items():
            ra, rb = uf.find(a), uf.find(b)
            if ra != rb:
                new.setdefault((min(ra, rb), max(ra, rb)), []).extend(vals)
        return new

    for thr in thresholds:
        while True:
            live = [((a, b), float(np.mean(v))) for (a, b), v in aff.items()
                    if uf.find(a) != uf.find(b)]
            if not live:
                break
            (a, b), best = max(live, key=lambda kv: kv[1])
            if best < thr:
                break
            uf.union(uf.find(a), uf.find(b))
            aff = rekey()
    return _materialize_groups(uf.groups(n), instances)


def merge_multicut_greedy(instances: List[Dict], edges: Dict[Tuple[int, int], float],
                          join_bias: float = 0.5) -> List[Dict]:
    """Greedy correlation clustering: contract the most attractive edge while
    an edge of positive logit cost remains; parallel edges' costs add."""

    def logit(p: float) -> float:
        p = min(max(p, 1e-4), 1 - 1e-4)
        return math.log(p / (1 - p))

    n = len(instances)
    uf = _UnionFind(n)
    cost = {k: logit(v) - logit(join_bias) for k, v in edges.items()}
    while True:
        live = [((a, b), c) for (a, b), c in cost.items() if uf.find(a) != uf.find(b)]
        live = [kv for kv in live if kv[1] > 0.0]
        if not live:
            break
        (a, b), _ = max(live, key=lambda kv: kv[1])
        uf.union(uf.find(a), uf.find(b))
        new: Dict[Tuple[int, int], float] = {}
        for (x, y), c in cost.items():
            rx, ry = uf.find(x), uf.find(y)
            if rx != ry:
                key = (min(rx, ry), max(rx, ry))
                new[key] = new.get(key, 0.0) + c
        cost = new
    return _materialize_groups(uf.groups(n), instances)


def merge_instances(instances: List[Dict], center_heatmap: np.ndarray, offsets: np.ndarray,
                    output_stride: int, method: str = "greedy", dilate_iters: int = 1,
                    w_valley: float = 1.0, w_offset: float = 0.25,
                    thresholds: Sequence[float] = (0.85, 0.6, 0.4),
                    join_bias: float = 0.5) -> List[Dict]:
    """Fuse over-segmented fragments of one animal (``method``: ``greedy``
    or ``multicut``)."""
    if len(instances) < 2:
        return list(instances)
    edges = build_merge_rag(instances, center_heatmap, offsets, output_stride,
                            dilate_iters=dilate_iters, w_valley=w_valley, w_offset=w_offset)
    if not edges:
        return list(instances)
    if method == "multicut":
        return merge_multicut_greedy(instances, edges, join_bias=join_bias)
    return merge_greedy_affinity(instances, edges, thresholds=thresholds)
