"""Inference layers: preprocess -> backend -> postprocess.

Port of the single-instance, top-down, bottom-up and identity part of
``sleap_nn_tpu/inference/layers.py``: ``PreprocessConfig``,
``PostprocessConfig``, ``preprocess_images``, ``SingleInstanceLayer``,
``CentroidLayer``, ``CenteredInstanceLayer``, ``TopDownLayer``,
``BottomUpLayer``, ``BottomUpMultiClassLayer`` and
``TopDownMultiClassLayer``, with the same output keys, shapes and
coordinate bookkeeping (eff_scale / scale / crop offsets lift coordinates
back to the original image).

PyTorch runs eagerly, so the JAX package's ``jit_layer`` has no
counterpart. ``predict_async`` enqueues a batch's device work and returns
device tensors without waiting; ``finalize`` copies them to numpy and runs
the layer's host step, ``postprocess_host`` (the identity for top-down, the
PAF grouping for bottom-up, the Hungarian class assignment for the
identity layers), which the predictor calls on the numpy it fetched
itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import numpy as np
import torch

from sleap_nn_tpu_torch.data.normalization import apply_channel_config, normalize_image
from sleap_nn_tpu_torch.data.resizing import apply_pad_to_stride, apply_sizematcher, resize_image
from sleap_nn_tpu_torch.inference.backends import resolve_device
from sleap_nn_tpu_torch.inference.identity import (
    get_class_inds_from_vectors,
    group_and_assemble,
)
from sleap_nn_tpu_torch.inference.paf_grouping import PAFScorer
from sleap_nn_tpu_torch.inference.streaming import group_batch_host
from sleap_nn_tpu_torch.ops.crops import crop_bboxes, make_centered_bboxes
from sleap_nn_tpu_torch.ops.peaks import find_global_peaks, find_local_peaks


@dataclasses.dataclass
class PreprocessConfig:
    """Static preprocessing params shared by all layers."""

    ensure_rgb: bool = False
    ensure_grayscale: bool = False
    max_height: Optional[int] = None
    max_width: Optional[int] = None
    scale: float = 1.0
    max_stride: int = 16

    def __post_init__(self):
        if self.ensure_rgb and self.ensure_grayscale:
            raise ValueError("ensure_rgb and ensure_grayscale cannot both be True")


@dataclasses.dataclass
class PostprocessConfig:
    """Peak-finding / grouping knobs (the top-down and bottom-up subset of the
    JAX package's config)."""

    peak_threshold: float = 0.2
    refinement: Optional[str] = "integral"
    integral_patch_size: int = 5
    max_instances: Optional[int] = None
    max_peaks: int = 200
    return_confmaps: bool = False
    # bottomup debug: emit the matched PAF candidate graph per sample as
    # (peaks, edge_inds, edge_peak_inds, line_scores) under "pred_paf_graph"
    return_paf_graph: bool = False
    # bottomup only
    k_per_node: int = 20
    n_points: int = 10
    max_edge_length_ratio: float = 0.25
    dist_penalty_weight: float = 1.0
    min_line_scores: float = 0.25


def preprocess_images(pre: PreprocessConfig, images: torch.Tensor):
    """uint8 (B, H, W, C) -> network-ready float batch + coordinate factor.

    Returns (x, eff_scale): predicted coords must be divided by
    ``pre.scale * eff_scale`` to land in original-image space.
    """
    x = normalize_image(images)
    x = apply_channel_config(x, pre.ensure_rgb, pre.ensure_grayscale)
    x, eff_scale = apply_sizematcher(x, pre.max_height, pre.max_width)
    if pre.scale != 1.0:
        x = resize_image(x, pre.scale)
    x = apply_pad_to_stride(x, pre.max_stride)
    return x, eff_scale


def to_host(out: Dict[str, Any]) -> Dict[str, Any]:
    """Device tensors -> numpy (bf16 as f32: numpy has no bfloat16; exact)."""
    host = {}
    for k, v in out.items():
        if torch.is_tensor(v):
            v = (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
        host[k] = v
    return host


class InferenceLayer:
    """Base: owns backend + configs; runs on the backend's device."""

    def __init__(self, backend, pre: PreprocessConfig, post: PostprocessConfig,
                 device="cuda"):
        self.device = resolve_device(device)
        if backend.device != self.device:
            raise ValueError(f"backend runs on {backend.device}, layer on {self.device}")
        self.backend = backend
        self.pre = pre
        self.post = post

    def _as_tensor(self, images) -> torch.Tensor:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        return images.to(self.device)

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        raise NotImplementedError

    def predict_async(self, images) -> Dict[str, Any]:
        with torch.inference_mode():
            return self.forward(self._as_tensor(images))

    def postprocess_host(self, host: Dict[str, Any]) -> Dict[str, Any]:
        """The layer's host step on its fetched numpy outputs (none here)."""
        return host

    def finalize(self, device_out: Dict[str, Any]) -> Dict[str, Any]:
        return self.postprocess_host(to_host(device_out))

    def predict(self, images) -> Dict[str, Any]:
        return self.finalize(self.predict_async(images))


class SingleInstanceLayer(InferenceLayer):
    """Full-frame single-instance confmap peaks: one instance per frame."""

    def __init__(self, backend, pre, post, head_name="SingleInstanceConfmapsHead",
                 output_stride=2, device="cuda"):
        super().__init__(backend, pre, post, device)
        self.head_name = head_name
        self.output_stride = output_stride

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        post = self.post
        x, eff_scale = preprocess_images(self.pre, images)
        cms = self.backend(x)[self.head_name]
        points, vals = find_global_peaks(
            cms,
            threshold=post.peak_threshold,
            refinement=post.refinement,
            integral_patch_size=post.integral_patch_size,
        )
        # NaN where no peak clears the threshold, in original-image coords.
        points = points * self.output_stride / (self.pre.scale * eff_scale)
        out = {"pred_keypoints": points[:, None], "pred_peak_values": vals[:, None]}
        if post.return_confmaps:
            out["confmaps"] = cms
        return out


class CentroidLayer(InferenceLayer):
    """Stage-1 centroid detection via local peaks."""

    def __init__(self, backend, pre, post, head_name="CentroidConfmapsHead",
                 output_stride=2, device="cuda"):
        super().__init__(backend, pre, post, device)
        self.head_name = head_name
        self.output_stride = output_stride

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        return self.forward_preprocessed(*preprocess_images(self.pre, images))

    def forward_preprocessed(self, x: torch.Tensor, eff_scale: float) -> Dict[str, Any]:
        post = self.post
        cms = self.backend(x)[self.head_name]
        points, vals, _, valid = find_local_peaks(
            cms,
            threshold=post.peak_threshold,
            refinement=post.refinement,
            integral_patch_size=post.integral_patch_size,
            max_peaks=post.max_instances or post.max_peaks,
        )
        # scaled-image coords (for stage-2 crops) and original coords.
        points_scaled = points * self.output_stride
        out = {
            "pred_centroids": points_scaled / (self.pre.scale * eff_scale),
            "centroids_scaled": points_scaled,
            "centroid_vals": vals,
            "centroid_valid": valid,
            "eff_scale": eff_scale,
        }
        if post.return_confmaps:
            out["confmaps"] = cms
        return out


class CenteredInstanceLayer(InferenceLayer):
    """Stage-2 per-crop confmap peaks.

    ``predict_on_crops`` takes crops in the SCALED image space; peaks come
    back in crop coordinates, callers add the crop offsets. It also returns
    the backend's outputs, for the heads beside the confmaps.
    """

    def __init__(self, backend, pre, post, head_name="CenteredInstanceConfmapsHead",
                 output_stride=2, device="cuda"):
        super().__init__(backend, pre, post, device)
        self.head_name = head_name
        self.output_stride = output_stride

    def predict_on_crops(self, crops: torch.Tensor):
        preds = self.backend(crops)
        points, vals = find_global_peaks(
            preds[self.head_name],
            threshold=self.post.peak_threshold,
            refinement=self.post.refinement,
            integral_patch_size=self.post.integral_patch_size,
        )
        return points * self.output_stride, vals, preds


class TopDownLayer(InferenceLayer):
    """Two-stage: centroids -> fixed-size crop gather -> instance peaks.

    Stage 2 runs on a fixed ``max_instances`` crops per frame, with
    invalid centroids masked (no data-dependent shapes).
    """

    def __init__(self, centroid_layer: CentroidLayer, instance_layer: CenteredInstanceLayer,
                 max_instances: int = 20, crop_size: int = 160, device="cuda"):
        self.device = resolve_device(device)
        for layer in (centroid_layer, instance_layer):
            if layer.device != self.device:
                raise ValueError(f"stage layer runs on {layer.device}, layer on {self.device}")
        self.centroid_layer = centroid_layer
        self.instance_layer = instance_layer
        self.max_instances = max_instances
        self.crop_size = crop_size

    def _stage2(self, images_scaled, centroids_scaled, valid):
        """images_scaled: stage-2-preprocessed frames (B, H, W, C);
        centroids_scaled: (B, K, 2) in the same scaled space."""
        crop = self.crop_size
        b, k = centroids_scaled.shape[:2]
        flat_c = centroids_scaled.reshape(b * k, 2)
        bboxes = make_centered_bboxes(flat_c, crop, crop)
        sample_inds = torch.arange(b, device=self.device).repeat_interleave(k)
        crops = crop_bboxes(images_scaled, bboxes, sample_inds, crop, crop)
        peaks, vals, preds = self.instance_layer.predict_on_crops(crops)  # crop coords
        # Integer-floored bbox top-left, as crop_bboxes takes it.
        half = crop // 2
        top_left = torch.trunc(flat_c - (crop - 1) / 2.0 + half) - half
        peaks = peaks + top_left[:, None, :]
        peaks = peaks.reshape(b, k, peaks.shape[1], 2)
        vals = vals.reshape(b, k, -1)
        peaks = torch.where(valid[..., None, None], peaks, torch.full_like(peaks, float("nan")))
        vals = torch.where(valid[..., None], vals, torch.zeros_like(vals))
        return peaks, vals, self._crop_extras(preds, b, k)

    def _crop_extras(self, preds: Dict[str, torch.Tensor], b: int, k: int) -> Dict[str, Any]:
        """Outputs of the instance model beside its peaks, per (frame, crop)."""
        return {}

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        c, inst, k = self.centroid_layer, self.instance_layer, self.max_instances
        x, eff = preprocess_images(c.pre, images)
        cres = c.forward_preprocessed(x, eff)
        # Frames preprocessed for stage 2 in the instance layer's space.
        x2, eff2 = (x, eff) if inst.pre == c.pre else preprocess_images(inst.pre, images)
        ratio = (inst.pre.scale * eff2) / (c.pre.scale * cres["eff_scale"])
        valid = cres["centroid_valid"][:, :k]
        cent2 = torch.nan_to_num(cres["centroids_scaled"][:, :k] * ratio, nan=-1e6)
        peaks, vals, extras = self._stage2(x2, cent2, valid)
        return {
            "pred_keypoints": peaks / (inst.pre.scale * eff2),
            "pred_peak_values": vals,
            "pred_centroids": cres["pred_centroids"][:, :k],
            "centroid_vals": cres["centroid_vals"][:, :k],
            "instance_valid": valid,
            **extras,
        }


class TopDownMultiClassLayer(TopDownLayer):
    """Top-down whose instance model also classifies each crop.

    Stage 2 returns the class-vectors head's output as ``class_probs``
    ``(B, K, n_classes)``. The host step gives each frame's valid instances
    distinct classes by Hungarian matching on their class vectors:
    ``pred_class_inds`` (-1 where none) and ``pred_class_scores``.
    """

    def __init__(self, centroid_layer: CentroidLayer, instance_layer: CenteredInstanceLayer,
                 max_instances: int = 20, crop_size: int = 160, n_classes: int = 0,
                 class_head: str = "ClassVectorsHead", device="cuda"):
        super().__init__(centroid_layer, instance_layer, max_instances, crop_size, device)
        self.n_classes = n_classes
        self.class_head = class_head

    def _crop_extras(self, preds, b, k):
        return {"class_probs": preds[self.class_head].reshape(b, k, -1)}

    def postprocess_host(self, host: Dict[str, Any]) -> Dict[str, Any]:
        probs = host["class_probs"]
        class_inds = np.full(probs.shape[:2], -1, dtype=np.int64)
        class_scores = np.full(probs.shape[:2], np.nan, dtype=np.float32)
        for i in range(probs.shape[0]):
            rows = np.nonzero(host["instance_valid"][i])[0]
            if len(rows):
                class_inds[i, rows], class_scores[i, rows] = get_class_inds_from_vectors(
                    probs[i][rows])
        host["pred_class_inds"] = class_inds
        host["pred_class_scores"] = class_scores
        return host


class BottomUpLayer(InferenceLayer):
    """Multi-instance confmaps + PAF grouping.

    Device: preprocess, UNet, local peaks over all node channels, PAF line
    scores of every candidate pair. Host (:meth:`postprocess_host`):
    Hungarian matching + greedy union into instances, per sample.
    """

    def __init__(self, backend, pre, post, paf_scorer: PAFScorer,
                 cm_head="MultiInstanceConfmapsHead", paf_head="PartAffinityFieldsHead",
                 cm_output_stride=2, device="cuda"):
        super().__init__(backend, pre, post, device)
        self.paf_scorer = paf_scorer
        self.cm_head = cm_head
        self.paf_head = paf_head
        self.cm_output_stride = cm_output_stride

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        post = self.post
        x, eff_scale = preprocess_images(self.pre, images)
        preds = self.backend(x)
        cms, pafs = preds[self.cm_head], preds[self.paf_head]
        points, vals, channels, valid = find_local_peaks(
            cms,
            threshold=post.peak_threshold,
            refinement=post.refinement,
            integral_patch_size=post.integral_patch_size,
            max_peaks=post.max_peaks,
        )
        points = points * self.cm_output_stride  # image (scaled) coords
        grouped_peaks, grouped_vals, mask, scores = self.paf_scorer.score_on_device(
            pafs, points, vals, channels, valid
        )
        out = {
            "grouped_peaks": grouped_peaks,
            "grouped_vals": grouped_vals,
            "scores": scores,
            "eff_scale": eff_scale,
        }
        if post.return_confmaps:
            out["confmaps"] = cms
            out["pafs"] = pafs
        return out

    def host_payload(self, host: Dict[str, Any]) -> Dict[str, Any]:
        """Fetched numpy outputs -> the picklable grouping payload."""
        payload = {
            "grouped_peaks": host["grouped_peaks"],
            "grouped_vals": host["grouped_vals"],
            "scores": host["scores"],
            "lift": 1.0 / (self.pre.scale * float(np.reshape(host["eff_scale"], -1)[0])),
        }
        for k in ("confmaps", "pafs"):
            if k in host:
                payload[k] = host[k]
        return payload

    def device_to_payload(self, dev: Dict[str, Any]) -> Dict[str, Any]:
        """Fetch the device outputs into a picklable numpy grouping payload."""
        return self.host_payload(to_host(dev))

    def postprocess_host(self, host: Dict[str, Any]) -> Dict[str, Any]:
        """Host grouping of the fetched scores into per-sample instances."""
        return group_batch_host(
            self.host_payload(host), self.paf_scorer, self.post.max_instances,
            return_paf_graph=self.post.return_paf_graph,
        )


class BottomUpMultiClassLayer(InferenceLayer):
    """Multi-instance confmaps + class maps -> one instance per class.

    Device: preprocess, UNet, local peaks over all node channels (with
    their unrefined positions), and each peak's class probabilities
    gathered from the class maps at its rounded (half to even), clipped
    class-map position: the host receives ``(B, K, n_classes)``, never the
    maps. Host (:meth:`postprocess_host`): Hungarian matching of peaks to
    classes per (sample, node), in the reference's scan order.
    """

    def __init__(self, backend, pre, post, n_nodes: int, n_classes: int,
                 cm_head="MultiInstanceConfmapsHead", class_head="ClassMapsHead",
                 cm_output_stride=2, class_maps_output_stride=2, device="cuda"):
        super().__init__(backend, pre, post, device)
        self.n_nodes = n_nodes
        self.n_classes = n_classes
        self.cm_head = cm_head
        self.class_head = class_head
        self.cm_output_stride = cm_output_stride
        self.class_maps_output_stride = class_maps_output_stride

    def forward(self, images: torch.Tensor) -> Dict[str, Any]:
        post = self.post
        x, eff_scale = preprocess_images(self.pre, images)
        preds = self.backend(x)
        class_maps = preds[self.class_head]
        points, vals, channels, valid, rough = find_local_peaks(
            preds[self.cm_head],
            threshold=post.peak_threshold,
            refinement=post.refinement,
            integral_patch_size=post.integral_patch_size,
            max_peaks=post.max_peaks,
            return_rough=True,
        )
        # Class-map grid coordinates. A 0-dim tensor divisor: ATen's CUDA
        # division by a Python scalar multiplies by its reciprocal.
        stride = torch.tensor(float(self.class_maps_output_stride), device=points.device)
        grid = points * self.cm_output_stride / stride
        b, h, w, _ = class_maps.shape
        xy = torch.round(torch.nan_to_num(grid)).long()
        cols, rows = xy[..., 0].clamp(0, w - 1), xy[..., 1].clamp(0, h - 1)
        samples = torch.arange(b, device=points.device)[:, None].expand_as(cols)
        return {
            "points": grid,
            "rough": rough,  # confmap grid, for the scan order of ties
            "vals": vals,
            "channels": channels,
            "valid": valid,
            "peak_class_probs": class_maps[samples, rows, cols],  # (B, K, n_classes)
            "eff_scale": eff_scale,
        }

    def postprocess_host(self, host: Dict[str, Any]) -> Dict[str, Any]:
        b, k = host["vals"].shape
        valid = host["valid"].reshape(-1)
        grouped_pts, grouped_vals, class_probs = group_and_assemble(
            host["points"].reshape(-1, 2)[valid],
            host["vals"].reshape(-1)[valid],
            np.repeat(np.arange(b), k)[valid],
            host["channels"].reshape(-1)[valid],
            host["peak_class_probs"].reshape(b * k, -1)[valid],
            b, self.n_classes, self.n_nodes,
            sort_keys=host["rough"].reshape(-1, 2)[valid],
        )
        eff_scale = float(np.reshape(host["eff_scale"], -1)[0])
        lift = self.class_maps_output_stride / (self.pre.scale * eff_scale)
        return {
            "pred_keypoints": grouped_pts * lift,
            "pred_peak_values": grouped_vals,
            "pred_class_probs": class_probs,
        }
