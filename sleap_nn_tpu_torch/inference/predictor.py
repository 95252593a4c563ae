"""Predictor: providers -> layer -> per-batch numpy outputs -> Labels.

Port of ``sleap_nn_tpu/inference/predictor.py`` for the single-instance,
top-down (centroid + centered-instance), bottom-up and identity
(multi-class bottom-up; centroid + multi-class top-down) models:
``from_model_paths`` builds the layer from trained model directories,
``predict`` runs it over a frame source and, with ``make_labels=True``,
``to_labels`` turns the per-batch outputs into ``Labels`` of
``PredictedInstance``s (through the instance filters; an identity model's
instances carry one ``Track`` per class). The other model
types and the knobs of features the port lacks raise
``NotImplementedError`` naming their ROADMAP.md item.

Pipeline on a CUDA device: the main thread decodes (through the
provider's prefetch thread), copies each batch from pinned host memory on
a copy stream and enqueues the layer's device work; a second copy stream
brings the outputs back into pinned buffers and records an event; a fetch
thread waits on each event in submission order, converts to numpy and runs
the layer's host step (``postprocess_host``: the PAF grouping of a
bottom-up layer). With ``paf_workers > 0`` a bottom-up layer's grouping
runs in a process pool instead, and results keep submission order.
"""

from __future__ import annotations

import contextlib
import logging
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from sleap_nn_tpu_torch.config import get_head_config
from sleap_nn_tpu_torch.inference.backends import TorchBackend, resolve_device
from sleap_nn_tpu_torch.inference.filters import FilterPipeline
from sleap_nn_tpu_torch.inference.layers import (
    BottomUpLayer,
    BottomUpMultiClassLayer,
    CenteredInstanceLayer,
    CentroidLayer,
    PostprocessConfig,
    PreprocessConfig,
    SingleInstanceLayer,
    TopDownLayer,
    TopDownMultiClassLayer,
    to_host,
)
from sleap_nn_tpu_torch.inference.loaders import LoadedModel, load_model
from sleap_nn_tpu_torch.inference.paf_grouping import PAFScorer
from sleap_nn_tpu_torch.inference.providers import LabelsProvider, VideoProvider
from sleap_nn_tpu_torch.inference.streaming import PafGroupingPool
from sleap_nn_tpu_torch.io.model import (
    LabeledFrame,
    Labels,
    PredictedInstance,
    Skeleton,
    Track,
)
from sleap_nn_tpu_torch.io.video import rgb_to_gray_uint8

logger = logging.getLogger("sleap_nn_tpu_torch")

# Knobs of the JAX ``from_model_paths`` whose features the port lacks:
# name -> (the value that asks for nothing, why another value raises).
_SEGMENTATION = "segmentation is not ported (ROADMAP.md section 1, item 10)"
UNPORTED_KNOBS = {
    "host_resize": (False, "host_resize resizes with cv2, which the port does not use "
                           "(ROADMAP.md section 1, item 3)"),
    "data_parallel": (False, "data-parallel inference over several cards is not ported "
                             "(ROADMAP.md section 1, item 13)"),
    "packed_level0": (None, "packed_level0 selects the JAX package's space-to-depth TPU "
                            "layout (ops/packed_conv.py), which the port has no copy of"),
    "centroid_only": (False, "centroid-only inference is not ported (ROADMAP.md section 1, "
                             "item 2)"),
    "anchor_part": (None, "ground-truth centroids (a lone centered-instance model) are not "
                          "ported (ROADMAP.md section 1, item 10)"),
    "backbone_ckpt_path": (None, "swapping backbone or head weights is not ported "
                                 "(ROADMAP.md section 1, item 2)"),
    "head_ckpt_path": (None, "swapping backbone or head weights is not ported "
                             "(ROADMAP.md section 1, item 2)"),
    **{name: (default, _SEGMENTATION) for name, default in (
        ("merge_fragments", False), ("merge_method", "greedy"), ("min_mask_area", 0),
        ("fg_threshold", 0.5), ("center_nms_kernel", 3), ("distance_gate_alpha", None),
        ("mask_cleanup", True), ("mask_cleanup_radius", 0), ("merge_dilate", 1),
        ("merge_w_valley", 1.0), ("merge_w_offset", 0.25),
        ("merge_thresholds", (0.85, 0.6, 0.4)), ("full_res_masks", False),
        ("mask_output", "mask"), ("polygon_epsilon", 0.01))},
}


def refuse_unported(knobs: Dict[str, Any], table: Dict[str, tuple], where: str) -> None:
    """Raise for a knob of ``table`` set to anything but its no-op value, and
    for a name that is not a knob at all."""
    for name, value in knobs.items():
        if name not in table:
            raise TypeError(f"{where}() got an unexpected keyword argument {name!r}")
        default, why = table[name]
        same = value == default
        if not (same if isinstance(same, bool) else bool(np.all(same))):
            raise NotImplementedError(f"{where}({name}={value!r}): {why}")


def _pre_config(loaded: LoadedModel) -> PreprocessConfig:
    """The layer's preprocessing from a model's training config. A
    one-channel model converts RGB to gray on the host unless it asked for
    RGB."""
    pre = loaded.config.data_config.preprocessing
    backbone = loaded.backbone_config
    ensure_grayscale = pre.ensure_grayscale
    if getattr(backbone, "in_channels", None) == 1 and not pre.ensure_rgb:
        ensure_grayscale = True
    return PreprocessConfig(
        ensure_rgb=pre.ensure_rgb,
        ensure_grayscale=ensure_grayscale,
        max_height=pre.max_height,
        max_width=pre.max_width,
        scale=pre.scale,
        max_stride=backbone.max_stride,
    )


def _crop_size(m: LoadedModel, crop_size: Optional[int], pre: PreprocessConfig) -> int:
    """The stage-2 crop: the override or the config's, scaled, rounded up
    to the max stride."""
    cs = crop_size or m.config.data_config.preprocessing.crop_size
    if cs is None:
        raise ValueError("crop_size not set in centered-instance config.")
    cs = int(round(cs * pre.scale))
    return cs + (-cs) % pre.max_stride


class Predictor:
    """Runs batched inference of one layer over a frame source.

    ``paf_workers``: for a bottom-up layer, the number of worker processes
    that group PAF scores into instances (0 groups on the fetch thread).
    ``filters``: an optional ``FilterConfig`` applied to each frame's
    instances by ``to_labels``. ``class_names``: an identity model's class
    names, which name the ``Track`` of each class.
    """

    def __init__(self, layer, model_type: str, skeleton=None, models: Sequence = (),
                 batch_size: int = 4, device="cuda", paf_workers: int = 0, filters=None):
        self.device = resolve_device(device)
        if layer.device != self.device:
            raise ValueError(f"layer runs on {layer.device}, predictor on {self.device}")
        self.layer = layer
        self.model_type = model_type
        self.skeleton = skeleton
        self.models = list(models)
        self.batch_size = batch_size
        self.paf_workers = paf_workers
        self.filters = filters
        self.class_names: Optional[List[str]] = None
        self._class_tracks: Dict[int, Track] = {}
        # Set by run.predict: frames are written as each batch completes;
        # whether the Labels will be tracked (for the run's summary line).
        self.stream_writer = None
        self.progress_callback = None
        self.tracking_active = False
        # A grayscale model gets its frames converted on the host, before
        # the copy to the device (3x fewer bytes).
        pre = getattr(getattr(layer, "centroid_layer", layer), "pre", None)
        self._host_grayscale = bool(pre and pre.ensure_grayscale)
        self.last_stats: Dict[str, float] = {}

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_model_paths(cls, model_paths: Sequence[Union[str, Path]], **kwargs) -> "Predictor":
        """A predictor from 1-2 model dirs; see ``_build_from_model_paths``."""
        return cls._build_from_model_paths(model_paths, **kwargs)

    @classmethod
    def _build_from_model_paths(
        cls,
        model_paths: Sequence[Union[str, Path]],
        peak_threshold: float = 0.2,
        refinement: str = "integral",
        integral_patch_size: int = 5,
        max_instances: Optional[int] = None,
        batch_size: int = 4,
        use_bf16: bool = False,
        max_peaks: int = 200,
        k_per_node: int = 20,
        min_line_scores: float = 0.25,
        crop_size: Optional[int] = None,
        return_confmaps: bool = False,
        return_paf_graph: bool = False,
        filters=None,
        paf_workers: int = 0,
        centroid_peak_threshold: Optional[float] = None,
        input_scale: Optional[float] = None,
        max_height: Optional[int] = None,
        max_width: Optional[int] = None,
        ensure_rgb: Optional[bool] = None,
        ensure_grayscale: Optional[bool] = None,
        max_edge_length_ratio: float = 0.25,
        dist_penalty_weight: float = 1.0,
        n_points: int = 10,
        min_instance_peaks: float = 0,
        device="cuda",
        **unported,
    ) -> "Predictor":
        """Load the model dirs and build the layer of their type set:
        ``{single_instance}``, ``{centroid, centered_instance}`` (top-down)
        or ``{bottomup}``. The preprocessing overrides trump each model's
        training config. The layers run on ``device`` (the card unless
        ``"cpu"``); the fused double-conv kernel runs there on a card.
        Identity models: ``{multi_class_bottomup}`` and ``{centroid,
        multi_class_topdown}``."""
        refuse_unported(unported, UNPORTED_KNOBS, "from_model_paths")
        device = resolve_device(device)
        loaded = [load_model(p) for p in model_paths]
        for m in loaded:
            p = m.config.data_config.preprocessing
            if input_scale is not None:
                p.scale = float(input_scale)
            if max_height is not None:
                p.max_height = int(max_height)
            if max_width is not None:
                p.max_width = int(max_width)
            if ensure_rgb is not None:
                p.ensure_rgb = bool(ensure_rgb)
            if ensure_grayscale is not None:
                p.ensure_grayscale = bool(ensure_grayscale)
        by_type: Dict[str, LoadedModel] = {}
        for m in loaded:
            if m.model_type in by_type:
                raise ValueError(
                    f"Duplicate model type {m.model_type!r} in model_paths; "
                    "pass at most one checkpoint per model type."
                )
            by_type[m.model_type] = m
        types = set(by_type)

        def post_for() -> PostprocessConfig:
            return PostprocessConfig(
                peak_threshold=peak_threshold,
                refinement=refinement,
                integral_patch_size=integral_patch_size,
                max_instances=max_instances,
                max_peaks=max_peaks,
                k_per_node=k_per_node,
                min_line_scores=min_line_scores,
                return_confmaps=return_confmaps,
                return_paf_graph=return_paf_graph,
            )

        def backend_for(m: LoadedModel) -> TorchBackend:
            return TorchBackend(m.model, m.params, use_bf16=use_bf16, device=device)

        def skeleton_for(m: LoadedModel) -> Skeleton:
            return Skeleton(nodes=m.skeleton_nodes, edges=m.skeleton_edges)

        def make(layer, model_type, m, class_names=None):
            p = cls(layer, model_type, skeleton_for(m), loaded, batch_size, device=device,
                    paf_workers=paf_workers, filters=filters)
            p.class_names = class_names
            return p

        def topdown_stages(mi):
            """The centroid layer and the centered-instance layer of ``mi``,
            with its crop size."""
            mc = by_type["centroid"]
            post_c = post_for()
            post_c.max_instances = max_instances or 20
            if centroid_peak_threshold is not None:
                post_c.peak_threshold = centroid_peak_threshold
            centroid_layer = CentroidLayer(
                backend_for(mc), _pre_config(mc), post_c,
                output_stride=get_head_config(mc.config).confmaps.output_stride, device=device)
            inst_pre = _pre_config(mi)
            instance_layer = CenteredInstanceLayer(
                backend_for(mi), inst_pre, post_for(),
                output_stride=get_head_config(mi.config).confmaps.output_stride, device=device)
            return dict(centroid_layer=centroid_layer, instance_layer=instance_layer,
                        max_instances=max_instances or 20,
                        crop_size=_crop_size(mi, crop_size, inst_pre), device=device)

        if types == {"single_instance"}:
            m = by_type["single_instance"]
            layer = SingleInstanceLayer(
                backend_for(m), _pre_config(m), post_for(),
                output_stride=get_head_config(m.config).confmaps.output_stride, device=device)
            return make(layer, "single_instance", m)

        if types == {"centroid", "centered_instance"}:
            mi = by_type["centered_instance"]
            return make(TopDownLayer(**topdown_stages(mi)), "topdown", mi)

        if types == {"centroid", "multi_class_topdown"}:
            mi = by_type["multi_class_topdown"]
            classes = list(get_head_config(mi.config).class_vectors.classes)
            layer = TopDownMultiClassLayer(**topdown_stages(mi), n_classes=len(classes))
            return make(layer, "multi_class_topdown", mi, classes)

        if types == {"multi_class_bottomup"}:
            m = by_type["multi_class_bottomup"]
            head = get_head_config(m.config)
            classes = list(head.class_maps.classes)
            layer = BottomUpMultiClassLayer(
                backend_for(m), _pre_config(m), post_for(),
                n_nodes=len(head.confmaps.part_names), n_classes=len(classes),
                cm_output_stride=head.confmaps.output_stride,
                class_maps_output_stride=head.class_maps.output_stride, device=device)
            return make(layer, "multi_class_bottomup", m, classes)

        if types == {"bottomup"}:
            m = by_type["bottomup"]
            head = get_head_config(m.config)
            scorer = PAFScorer(
                part_names=head.confmaps.part_names,
                edges=[tuple(e) for e in head.pafs.edges],
                pafs_stride=head.pafs.output_stride,
                max_edge_length_ratio=max_edge_length_ratio,
                dist_penalty_weight=dist_penalty_weight,
                n_points=n_points,
                min_instance_peaks=min_instance_peaks,
                min_line_scores=min_line_scores,
                k_per_node=k_per_node,
            )
            layer = BottomUpLayer(backend_for(m), _pre_config(m), post_for(), paf_scorer=scorer,
                                  cm_output_stride=head.confmaps.output_stride, device=device)
            return make(layer, "bottomup", m)

        if types == {"centroid"}:
            why = "centroid-only inference is not ported (ROADMAP.md section 1, item 2)"
        elif types == {"centered_instance"}:
            why = ("a lone centered-instance model predicts from ground-truth centroids, "
                   "which are not ported (ROADMAP.md section 1, item 10)")
        else:
            raise ValueError(f"Unsupported model type combination: {sorted(types)}")
        raise NotImplementedError(why)

    # -- prediction -----------------------------------------------------------
    def _make_provider(self, data, frames=None):
        is_slp = isinstance(data, (str, Path)) and str(data).endswith(".slp")
        if (isinstance(data, Labels) or is_slp) and frames is not None:
            raise ValueError("frames selects frames of a video; a Labels source predicts its "
                             "labeled frames (run.predict's only_suggested_frames predicts "
                             "its suggestions)")
        if isinstance(data, Labels):
            return LabelsProvider(data, batch_size=self.batch_size)
        if isinstance(data, (str, Path)):
            if is_slp:
                from sleap_nn_tpu_torch.io.slp import load_slp

                return LabelsProvider(load_slp(data), batch_size=self.batch_size)
            raise NotImplementedError(
                f"reading the video file {str(data)!r} needs the media video backends, which "
                "are not ported (ROADMAP.md section 1, item 3); pass a Labels, a .slp path or "
                "an object with __len__ and get_frame(idx, fmt)")
        return VideoProvider(data, batch_size=self.batch_size, frames=frames,
                             out_format="gray" if self._host_grayscale else None)

    def _send(self, frames: np.ndarray, h2d) -> torch.Tensor:
        """Host frames -> device, through pinned memory on the copy stream."""
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if h2d is None:
            return host.to(self.device)
        host = host.pin_memory()
        compute = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(h2d):
            dev = host.to(self.device, non_blocking=True)
        compute.wait_stream(h2d)
        dev.record_stream(compute)
        return dev

    def _fetch_async(self, out: Dict[str, Any], d2h):
        """Enqueue device -> pinned host copies; returns (event or None, host dict).

        bf16 tensors come back as f32 (exact): numpy has no bfloat16.
        """
        if d2h is None:
            return None, to_host(out)
        d2h.wait_stream(torch.cuda.current_stream(self.device))
        host = {}
        with torch.cuda.stream(d2h):
            for k, v in out.items():
                if not torch.is_tensor(v):
                    host[k] = v
                    continue
                v.record_stream(d2h)
                if v.dtype == torch.bfloat16:
                    v = v.float()
                host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(d2h)
        return done, host

    def predict(self, data=None, frames: Optional[Sequence[int]] = None,
                make_labels: bool = True, provider=None):
        """Run inference over a frame source: a ``Labels``, a ``.slp`` path or
        a video (an object with ``__len__`` and ``get_frame(idx, fmt)``).

        With ``make_labels`` returns ``Labels``; else the per-batch output
        dicts, each holding the layer's outputs as numpy plus
        ``frame_inds``, ``video_inds`` and ``valid`` (False on the padded
        rows of a short last batch).
        """
        provider = provider or self._make_provider(data, frames)
        videos = self._provider_videos(provider)
        writer = self.stream_writer
        stream_frames: List[LabeledFrame] = []
        cuda = self.device.type == "cuda"
        h2d = torch.cuda.Stream(self.device) if cuda else None
        d2h = torch.cuda.Stream(self.device) if cuda else None
        results: List[Dict[str, Any]] = []
        errors: List[Exception] = []
        fetch_q: "queue.Queue" = queue.Queue(maxsize=3)
        n_frames = 0
        pool = None
        if self.paf_workers > 0 and hasattr(self.layer, "host_payload"):
            pool = PafGroupingPool(self.paf_workers, self.layer.paf_scorer,
                                   self.layer.post.max_instances,
                                   return_paf_graph=self.layer.post.return_paf_graph)
        pool_batches: List = []  # by submission ordinal

        def emit(out, batch):
            nonlocal n_frames
            out["frame_inds"] = batch.frame_inds
            out["video_inds"] = batch.video_inds
            out["valid"] = batch.valid
            n_frames += int(batch.valid.sum())
            results.append(out)
            if writer is not None:
                frames_out = self._frames_from_out(out, videos)
                writer.add_frames(frames_out)
                stream_frames.extend(frames_out)
            if self.progress_callback is not None:
                self.progress_callback(n_frames)

        def fetcher():
            # One consumer, so results keep submission order.
            while True:
                item = fetch_q.get()
                if item is None:
                    return
                if errors:
                    continue  # keep draining so the producer never blocks
                try:
                    (done, host), batch = item
                    if done is not None:
                        done.synchronize()
                    out = {k: (np.array(v.numpy()) if torch.is_tensor(v) else v)
                           for k, v in host.items()}
                    if pool is None:
                        emit(self.layer.postprocess_host(out), batch)
                        continue
                    pool.submit(len(pool_batches), self.layer.host_payload(out))
                    pool_batches.append(batch)
                    if len(pool) > 2 * self.paf_workers:  # bound the backlog
                        ordinal, grouped = pool.drain_one()
                        emit(grouped, pool_batches[ordinal])
                except Exception as e:  # raised again on the main thread
                    errors.append(e)

        t0 = time.perf_counter()
        with pool if pool is not None else contextlib.nullcontext():
            thread = threading.Thread(target=fetcher, name="sleap-nn-torch-fetch", daemon=True)
            thread.start()
            batches = iter(provider)
            try:
                for batch in batches:
                    if errors:
                        break
                    frames_b = batch.frames
                    if self._host_grayscale and frames_b.shape[-1] == 3:
                        frames_b = rgb_to_gray_uint8(frames_b)
                    out = self.layer.predict_async(self._send(frames_b, h2d))
                    fetch_q.put((self._fetch_async(out, d2h), batch))
            finally:
                fetch_q.put(None)
                thread.join()
                if hasattr(batches, "close"):
                    batches.close()
            if errors:
                raise errors[0]
            if pool is not None:
                for ordinal, grouped in pool.iter_completed():
                    emit(grouped, pool_batches[ordinal])
        elapsed = time.perf_counter() - t0
        self.last_stats = {
            "n_frames": n_frames,
            "elapsed_s": elapsed,
            "fps": n_frames / elapsed if elapsed > 0 else 0.0,
        }
        if not make_labels:
            self._log_inference_summary()
            return results
        labels = self.to_labels(
            results, video=provider.video if isinstance(provider, VideoProvider) else None,
            labels_src=provider.labels if isinstance(provider, LabelsProvider) else None,
            precomputed_frames=stream_frames if writer is not None else None)
        self._log_inference_summary(sum(len(lf.instances) for lf in labels.labeled_frames))
        return labels

    def _log_inference_summary(self, n_instances: Optional[int] = None) -> None:
        """One log line after a run: frames, instances, time, frames/s and
        whether the Labels will be tracked."""
        s = self.last_stats
        parts = [f"frames={s['n_frames']}"]
        if n_instances is not None:
            mean = n_instances / s["n_frames"] if s["n_frames"] else 0.0
            parts.append(f"instances={n_instances} ({mean:.2f}/frame)")
        parts += [f"elapsed={s['elapsed_s']:.1f}s", f"throughput={s['fps']:.1f} fps",
                  f"tracking={self.tracking_active}"]
        logger.info("Inference complete | " + " | ".join(parts))

    # -- conversion -------------------------------------------------------------
    @staticmethod
    def _provider_videos(provider) -> List:
        """The videos a provider's ``video_inds`` index."""
        if isinstance(provider, LabelsProvider):
            return list(provider.labels.videos)
        video = getattr(provider, "video", None)
        return [video] if video is not None else []

    def to_labels(self, results: List[Dict], video=None, labels_src=None,
                  precomputed_frames: Optional[List[LabeledFrame]] = None) -> Labels:
        """Batch outputs -> ``Labels`` of ``PredictedInstance``s, in frame
        order, with the run's provenance. ``video_inds`` index the videos of
        ``labels_src``, else ``[video]``; ``precomputed_frames`` are the
        frames a stream writer already converted."""
        videos = labels_src.videos if labels_src is not None else (
            [video] if video is not None else [])
        if precomputed_frames is not None:
            lfs = list(precomputed_frames)
        else:
            lfs = []
            for out in results:
                lfs.extend(self._frames_from_out(out, videos))
        labels = Labels(labeled_frames=lfs, videos=[v for v in videos if v is not None])
        if self._class_tracks:
            labels.tracks = list(self._class_tracks.values())
        from sleap_nn_tpu_torch.inference.provenance import build_inference_provenance

        labels.provenance = build_inference_provenance(
            [m.model_dir for m in self.models], stats=self.last_stats or None,
            backend=self.device.type)
        return labels

    def _frames_from_out(self, out: Dict, videos: Sequence) -> List[LabeledFrame]:
        """One batch output dict -> its ``LabeledFrame``s, in frame order.
        Padded rows (``valid`` False) and frames left without an instance
        give no frame."""
        skel = self.skeleton
        lfs: List[LabeledFrame] = []
        for i in range(len(out["frame_inds"])):
            if not out["valid"][i]:
                continue
            vid = videos[out["video_inds"][i]] if videos else None
            instances = []
            if self.model_type == "single_instance":
                pts, vals = out["pred_keypoints"][i], out["pred_peak_values"][i]
                for k in range(pts.shape[0]):
                    if not np.all(np.isnan(pts[k])):
                        instances.append(self._make_instance(pts[k], vals[k], skel))
            elif self.model_type == "topdown":
                pts, vals = out["pred_keypoints"][i], out["pred_peak_values"][i]
                valid = out["instance_valid"][i]
                for k in range(pts.shape[0]):
                    if valid[k] and not np.all(np.isnan(pts[k])):
                        instances.append(self._make_instance(pts[k], vals[k], skel))
            elif self.model_type == "bottomup":
                pts_list, vals_list = out["pred_keypoints"][i], out["pred_peak_values"][i]
                scores = out["pred_instance_scores"][i]
                for k in range(len(pts_list)):
                    if not np.all(np.isnan(pts_list[k])):
                        instances.append(self._make_instance(
                            pts_list[k], vals_list[k], skel, score=float(scores[k])))
            elif self.model_type == "multi_class_bottomup":
                # One row per class: its instance, if any of its nodes was found.
                pts = out["pred_keypoints"][i]
                vals = np.nan_to_num(out["pred_peak_values"][i])
                probs = out["pred_class_probs"][i]
                for k in range(pts.shape[0]):
                    if not np.all(np.isnan(pts[k])):
                        inst = self._make_instance(pts[k], vals[k], skel)
                        inst.track = self._class_track(k)
                        inst.tracking_score = float(np.nanmean(probs[k]))
                        instances.append(inst)
            elif self.model_type == "multi_class_topdown":
                pts, vals = out["pred_keypoints"][i], out["pred_peak_values"][i]
                valid = out["instance_valid"][i]
                cls_inds, cls_scores = out["pred_class_inds"][i], out["pred_class_scores"][i]
                for k in range(pts.shape[0]):
                    if valid[k] and not np.all(np.isnan(pts[k])):
                        inst = self._make_instance(pts[k], vals[k], skel)
                        if cls_inds[k] >= 0:
                            inst.track = self._class_track(int(cls_inds[k]))
                            inst.tracking_score = float(np.nan_to_num(cls_scores[k]))
                        instances.append(inst)
            else:
                raise NotImplementedError(
                    f"Labels output of model type {self.model_type!r} is not ported")
            if self.filters is not None and self.filters.enabled():
                instances = FilterPipeline(self.filters).apply(instances)
            if instances:
                lfs.append(LabeledFrame(video=vid, frame_idx=int(out["frame_inds"][i]),
                                        instances=instances))
        return lfs

    def _class_track(self, class_idx: int) -> Track:
        """The ``Track`` of an identity class (one per class and predictor),
        named after the class, or its index where the class has no name."""
        if class_idx not in self._class_tracks:
            names = self.class_names
            name = names[class_idx] if names and class_idx < len(names) else str(class_idx)
            self._class_tracks[class_idx] = Track(name=name)
        return self._class_tracks[class_idx]

    @staticmethod
    def _make_instance(pts, vals, skel, score=None) -> PredictedInstance:
        """Points and peak values -> a ``PredictedInstance``; the score is
        the mean peak value of the found nodes unless given."""
        vals = np.nan_to_num(np.asarray(vals, dtype=np.float64))
        visible = ~np.isnan(np.asarray(pts)[:, 0])
        if score is None:
            score = float(vals[visible].mean()) if visible.any() else 0.0
        return PredictedInstance(
            points=np.asarray(pts, dtype=np.float64),
            skeleton=skel,
            point_scores=vals,
            score=score,
        )
