"""The top-down pose pipeline in plain PyTorch, and the judge of a program's
answers against it.

Pipeline of one batch of uint8 frames (B, H, W, 1):

1. ``x = frames / 255`` in float32 (H and W multiples of the UNet's stride);
2. centroid maps: the centroid UNet on ``x``; a frame's centroids are its
   ``max_instances`` highest local peaks above the threshold, refined, in
   image pixels (cell * stride);
3. one ``crop x crop`` crop of ``x`` a centroid, its top-left corner
   ``trunc(c + 0.5) - crop // 2`` (zeros outside the frame);
4. instance maps: the centered-instance UNet on the crops; each node's
   global peak, refined, in image pixels (cell * stride + corner); NaN
   below the threshold.

The judge takes the program's answers for some frames (centroids, their
values and validity, keypoints and their values) and measures, against the
float32 maps of this pipeline computed at the program's own centroids:

- ``centroid_gap``: how far the reference's value at a reported centroid
  lies below the reference's ``max_instances``-th highest local peak;
- ``peak_gap``: how far the reference's value at a reported keypoint lies
  below the reference's highest value of that node in the crop;
- ``value_err``: the largest gap between a reported value and the
  reference's at the reported cell;
- ``coord_err_px``: the largest distance in image pixels between a
  reported position and the reference's refinement of the reported cell;
- each of these four as its largest (``_max`` dropped) and its mean
  (``_mean``) over the compared answers, and their count (``_n``);
- ``count_err``: frames whose number of centroids, or keypoints whose
  presence (a NaN where the reference finds a peak, or the reverse),
  differs from the reference's.

A reported position is matched to the cell it was refined from by
:func:`peaks.nearest_cell`. The reference's maps are rounded to the
precision the program's maps are stated in (``TopDownSpec.maps``, bf16
for the predict mixes) before anything is read from them: the program
reports values of such maps, and the rounding is then no error of its.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from portbench.reference import peaks, unet

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
CENTROID_HEAD = "CentroidConfmapsHead"
INSTANCE_HEAD = "CenteredInstanceConfmapsHead"


@dataclass(frozen=True)
class TopDownSpec:
    stride_c: int
    stride_i: int
    crop: int
    max_instances: int
    threshold: float
    patch: int = 5
    maps: Optional[torch.dtype] = None  # the maps' precision; None keeps float32

    @classmethod
    def of(cls, cfg: Dict, maps: Optional[str] = None) -> "TopDownSpec":
        return cls(cfg["centroid"]["confmaps"]["output_stride"],
                   cfg["centered_instance"]["confmaps"]["output_stride"],
                   cfg["crop_size"], cfg["max_instances"], cfg["peak_threshold"],
                   cfg["integral_patch_size"], DTYPES[maps] if maps else None)

    def round(self, maps: torch.Tensor) -> torch.Tensor:
        return maps if self.maps is None else maps.to(self.maps).float()


def crop_corners(centroids: torch.Tensor, crop: int) -> torch.Tensor:
    """Integer top-left corners (n, 2) of the crops around ``centroids`` (n, 2)."""
    return torch.trunc(centroids + 0.5).long() - crop // 2


def gather_crops(x: torch.Tensor, rows: torch.Tensor, corners: torch.Tensor,
                 crop: int) -> torch.Tensor:
    """``crop x crop`` windows of ``x`` (B, H, W, C) at ``corners``, zero outside."""
    _, h, w, _ = x.shape
    d = torch.arange(crop, device=x.device)
    ys, xs = corners[:, 1:2] + d[None], corners[:, 0:1] + d[None]
    inside = ((ys >= 0) & (ys < h))[:, :, None] & ((xs >= 0) & (xs < w))[:, None, :]
    out = x[rows[:, None, None], ys.clamp(0, h - 1)[:, :, None], xs.clamp(0, w - 1)[:, None, :]]
    return torch.where(inside[..., None], out, torch.zeros((), dtype=x.dtype, device=x.device))


def inputs(frames: torch.Tensor) -> torch.Tensor:
    return frames.to(torch.float32) / 255.0


def predict(state_c, state_i, frames: torch.Tensor, spec: TopDownSpec,
            conv: unet.Conv = unet.plain_conv) -> Dict[str, torch.Tensor]:
    """The pipeline's answers for uint8 ``frames``, under the program's keys."""
    x = inputs(frames)
    b, k = x.shape[0], spec.max_instances
    cms = spec.round(unet.forward(state_c, x, {CENTROID_HEAD: spec.stride_c}, conv)[CENTROID_HEAD])
    xy, cvals, _, valid = peaks.top_local_peaks(cms, spec.threshold, k)
    maps_c = cms[..., 0].repeat_interleave(k, dim=0)
    cent = peaks.refine(maps_c, xy.reshape(-1, 2), spec.patch).reshape(b, k, 2) * spec.stride_c
    cent = torch.where(valid[..., None], cent, torch.full_like(cent, float("nan")))
    rows = torch.arange(b, device=x.device).repeat_interleave(k)
    corners = crop_corners(torch.nan_to_num(cent.reshape(-1, 2), nan=-1e6), spec.crop)
    crops = gather_crops(x, rows, corners, spec.crop)
    ims = spec.round(unet.forward(state_i, crops, {INSTANCE_HEAD: spec.stride_i}, conv)[INSTANCE_HEAD])
    n_nodes = ims.shape[-1]
    gxy, gvals, gvalid = peaks.global_peaks(ims, spec.threshold)
    maps_i = ims.permute(0, 3, 1, 2).reshape(-1, *ims.shape[1:3])
    pts = peaks.refine(maps_i, gxy.reshape(-1, 2), spec.patch).reshape(b * k, n_nodes, 2)
    pts = pts * spec.stride_i + corners[:, None, :].float()
    ok = gvalid & valid.reshape(-1)[:, None]
    pts = torch.where(ok[..., None], pts, torch.full_like(pts, float("nan")))
    return {
        "pred_keypoints": pts.reshape(b, k, n_nodes, 2),
        "pred_peak_values": torch.where(ok, gvals, torch.zeros_like(gvals)).reshape(b, k, n_nodes),
        "pred_centroids": cent,
        "centroid_vals": cvals,
        "instance_valid": valid,
    }


def judge(state_c, state_i, frames: torch.Tensor, answers: Dict[str, np.ndarray],
          spec: TopDownSpec) -> Dict[str, float]:
    """The judge's numbers (see the module doc) for ``frames`` (B, H, W, 1)
    uint8 on the reference's device and the program's ``answers`` for them
    (numpy, the program's keys, rows in the order of ``frames``)."""
    dev = frames.device
    a = {key: torch.as_tensor(np.asarray(v), device=dev) for key, v in answers.items()}
    x = inputs(frames)
    b, k = x.shape[0], spec.max_instances
    gaps_c, gaps_p, errs_v, dists = [], [], [], []
    count_err = 0

    cms = spec.round(unet.forward(state_c, x, {CENTROID_HEAD: spec.stride_c})[CENTROID_HEAD])
    _, ref_vals, _, ref_valid = peaks.top_local_peaks(cms, spec.threshold, k)
    valid = a["instance_valid"].bool()
    count_err += int((valid.sum(1) != ref_valid.sum(1)).sum())
    kth = torch.where(ref_valid, ref_vals, torch.full_like(ref_vals, float("inf"))).amin(dim=1)
    rows = torch.arange(b, device=dev).repeat_interleave(k)[valid.reshape(-1)]
    if len(rows):
        cent = a["pred_centroids"].float().reshape(-1, 2)[valid.reshape(-1)]
        maps = cms[..., 0][rows]
        cell, dist = peaks.nearest_cell(maps, cent / spec.stride_c, spec.patch)
        v = peaks.values_at(maps, cell)
        got = a["centroid_vals"].float().reshape(-1)[valid.reshape(-1)]
        gaps_c.append((kth[rows] - v).clamp(min=0))
        errs_v.append((got - v).abs())
        dists.append(dist * spec.stride_c)

        corners = crop_corners(cent, spec.crop)
        crops = gather_crops(x, rows, corners, spec.crop)
        ims = spec.round(unet.forward(state_i, crops, {INSTANCE_HEAD: spec.stride_i})[INSTANCE_HEAD])
        n_nodes = ims.shape[-1]
        _, best, ref_ok = peaks.global_peaks(ims, spec.threshold)  # (n, N)
        kp = a["pred_keypoints"].float().reshape(-1, n_nodes, 2)[valid.reshape(-1)]
        kv = a["pred_peak_values"].float().reshape(-1, n_nodes)[valid.reshape(-1)]
        has = torch.isfinite(kp).all(dim=-1)
        count_err += int((has != ref_ok).sum())
        both = has & ref_ok
        if both.any():
            maps_i = ims.permute(0, 3, 1, 2)[both]  # (m, h, w)
            p = (kp - corners[:, None, :].float())[both] / spec.stride_i
            cell, dist = peaks.nearest_cell(maps_i, p, spec.patch)
            v = peaks.values_at(maps_i, cell)
            gaps_p.append((best[both] - v).clamp(min=0))
            errs_v.append((kv[both] - v).abs())
            dists.append(dist * spec.stride_i)
    out = {"count_err": count_err}
    for name, parts in (("centroid_gap", gaps_c), ("peak_gap", gaps_p), ("value_err", errs_v),
                        ("coord_err_px", dists)):
        t = torch.cat(parts) if parts else torch.zeros(1, device=dev)
        out[name] = float(t.max())
        out[name + "_mean"] = float(t.mean())
        out[name + "_n"] = int(t.numel())
    return out
