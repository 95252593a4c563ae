"""Predictor: providers -> layer -> per-batch numpy outputs -> Labels.

Port of ``sleap_nn_tpu/inference/predictor.py`` for the single-instance,
centroid-only, top-down (centroid + centered-instance), centered-instance
alone (on the ground-truth centroids of a labels source), bottom-up and
identity (multi-class bottom-up; centroid + multi-class top-down) models:
``from_model_paths`` builds the layer from trained model directories
(optionally with another dir's backbone or head weights swapped in),
``predict`` runs it over a frame source (a ``Labels``, a ``.slp`` or video
file, or a video object) and, with ``make_labels=True``, ``to_labels``
turns the per-batch outputs into ``Labels`` of ``PredictedInstance``s
(through the instance filters; an identity model's instances carry one
``Track`` per class; a centroid model's frames hold one-node instances,
``PredictedCentroid`` records or both; a segmentation model's frames hold
its ``SegmentationMask``s, and with ``mask_output`` ``"polygon"`` or
``"both"`` their outlines as ``PredictedROI``s). The knobs of features
the port lacks raise ``NotImplementedError`` naming their ROADMAP.md item.

Pipeline on a CUDA device: the provider's thread decodes each batch and
runs the host step on it (RGB to gray for a grayscale model; with
``host_resize``, the resize); the main thread copies each batch from
pinned host memory on a copy stream and enqueues the layer's device work;
a second copy stream brings the outputs back into pinned buffers and
records an event; a fetch thread waits on each event in submission order,
converts to numpy and runs the layer's host step (``postprocess_host``:
the PAF grouping of a bottom-up layer), then lifts host-resized
coordinates back. With ``data_parallel``, the main thread copies and
enqueues each replica's rows of the batch in turn (each replica past the
first on streams of its own), and the fetch thread joins the replicas'
outputs in row order before the host step. With ``paf_workers > 0`` a bottom-up layer's grouping
runs in a process pool instead, and results keep submission order.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import logging
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from sleap_nn_tpu_torch.config import get_backbone_type_from_cfg, get_head_config
from sleap_nn_tpu_torch.inference.backends import TorchBackend, resolve_device
from sleap_nn_tpu_torch.inference.filters import FilterPipeline
from sleap_nn_tpu_torch.inference.identity import group_and_assemble
from sleap_nn_tpu_torch.inference.layers import (
    BottomUpLayer,
    BottomUpMultiClassLayer,
    CenteredInstanceLayer,
    CentroidLayer,
    GTCentroidTopDownLayer,
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
from sleap_nn_tpu_torch.inference.segmentation import (
    BottomUpSegmentationLayer,
    SemanticSegmentationLayer,
    TopDownSegmentationLayer,
    mask_to_polygon,
)
from sleap_nn_tpu_torch.inference.streaming import PafGroupingPool, group_batch_host
from sleap_nn_tpu_torch.io.model import (
    LabeledFrame,
    Labels,
    PredictedCentroid,
    PredictedInstance,
    PredictedROI,
    Skeleton,
    Track,
)
from sleap_nn_tpu_torch.io.video import rgb_to_gray_uint8
from sleap_nn_tpu_torch.models.model import swap_subtrees
from sleap_nn_tpu_torch.parallel.mesh import get_mesh, replicate, shard_batch_spec

logger = logging.getLogger("sleap_nn_tpu_torch")

# Knobs of the JAX ``from_model_paths`` whose features the port lacks:
# name -> (the value that asks for nothing, why another value raises).
UNPORTED_KNOBS = {
    "packed_level0": (None, "packed_level0 selects the JAX package's space-to-depth TPU "
                            "layout (ops/packed_conv.py), which the port has no copy of"),
}
SEGMENTATION_TYPES = ("bottomup_segmentation", "semantic_segmentation", "topdown_segmentation")


class _Built(NamedTuple):
    """What ``from_model_paths`` builds on one device: the layer, and the
    model type, model, class names and skeleton of its predictor."""

    layer: Any
    model_type: str
    model: LoadedModel
    class_names: Optional[List[str]] = None
    skeleton: Optional[Skeleton] = None


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


def _crop_size(m: LoadedModel, crop_size: Optional[int], pre: PreprocessConfig,
               what: str = "centered-instance") -> int:
    """The stage-2 crop: the override or the config's, scaled (by the
    config's scale, also where the host resizes), rounded up to the max
    stride."""
    cs = crop_size or m.config.data_config.preprocessing.crop_size
    if cs is None:
        raise ValueError(f"crop_size not set in {what} config.")
    cs = int(round(cs * (pre.scale if m.host_scale is None else m.host_scale)))
    return cs + (-cs) % pre.max_stride


def _swap_param_subtrees(loaded: Sequence[LoadedModel], backbone_ckpt_path,
                         head_ckpt_path) -> None:
    """Replace the backbone / head weights of every loaded model with those
    of another model dir's checkpoint, in place. "head" is every subtree
    but the backbone. A subtree the source lacks, or one whose keys or
    shapes differ, raises ``ValueError`` instead of mixing incompatible
    weights."""
    for src_path, which in ((backbone_ckpt_path, "backbone"), (head_ckpt_path, "head")):
        if src_path is None:
            continue
        src = load_model(src_path).params
        for m in loaded:
            swap_subtrees(
                m.params, src, which,
                missing="{which}_ckpt_path: source checkpoint has no '{name}' subtree "
                        "(has: {trees}).",
                mismatch="{which}_ckpt_path: '{name}' parameter shapes do not match the "
                         "target model.")


# The type sets on full frames whose resize may move to the host.
_HOST_RESIZE_TYPES = ({"single_instance"}, {"centroid"}, {"centroid", "centered_instance"},
                      {"bottomup"}, {"multi_class_bottomup"}, {"centroid", "multi_class_topdown"})


def _move_resize_to_host(loaded: Sequence[LoadedModel], types) -> Optional[tuple]:
    """``(scale, max_height, max_width)`` for the host to apply, where the
    type set qualifies, every model preprocesses alike and there is a
    resize to do; each model's config then resizes nothing and keeps its
    scale as ``host_scale``. Else None (the device resizes)."""
    pres = [m.config.data_config.preprocessing for m in loaded]
    dims = [(p.scale, p.max_height, p.max_width) for p in pres]
    if types not in _HOST_RESIZE_TYPES or len(set(dims)) != 1 \
            or (pres[0].scale == 1.0 and not pres[0].max_height and not pres[0].max_width):
        return None
    transform = (float(pres[0].scale or 1.0), pres[0].max_height, pres[0].max_width)
    for m, p in zip(loaded, pres):
        m.host_scale = float(p.scale or 1.0)
        p.scale, p.max_height, p.max_width = 1.0, None, None
    return transform


def _host_numpy(done, host: Dict[str, Any]) -> Dict[str, Any]:
    """Wait for a batch's copies to the host (``done``: their event, or
    None), then its outputs as numpy."""
    if done is not None:
        done.synchronize()
    return {k: (np.array(v.numpy()) if torch.is_tensor(v) else v) for k, v in host.items()}


class _Replicas:
    """The replicas of one ``predict`` run: a layer a device of the mesh.
    The first is the predictor's own layer, on its device's current stream
    and the predictor's copy streams; every other replica has copy and
    compute streams of its own on a card, so that two replicas on one card
    overlap as two cards do.

    :meth:`enqueue` splits a batch into contiguous rows, one block a
    replica (the batch divides: the providers pad every batch to the
    predictor's batch size, which ``from_model_paths`` checks), sends each
    replica its rows and enqueues its device work and its copy back, one
    replica after another on the calling thread; :meth:`join` puts the
    fetched outputs together in row order, so the layer's host step sees
    one batch. Row outputs are the layer's device tensors of one or more
    dimensions; anything else (a 0-d tensor, an array the layer made on the
    host such as the frames' size) is the same on every replica."""

    def __init__(self, layers: Sequence, mesh: Sequence[torch.device], h2d, d2h):
        self.layers = list(layers)
        self.mesh = list(mesh)
        self.streams = [(h2d, d2h, None)] + [
            tuple(torch.cuda.Stream(d) for _ in range(3)) if d.type == "cuda" else (None,) * 3
            for d in self.mesh[1:]]

    def enqueue(self, predictor: "Predictor", arrays: List[np.ndarray]) -> List[tuple]:
        """Each replica's fetch: (event or None, host dict, names of the row
        outputs)."""
        fetched = []
        for layer, device, (h2d, d2h, compute), rows in zip(
                self.layers, self.mesh, self.streams, shard_batch_spec(len(arrays[0]), self.mesh)):
            with torch.cuda.stream(compute) if compute is not None else contextlib.nullcontext():
                out = layer.predict_async(*[predictor._send(a[rows], h2d, device) for a in arrays])
                fetched.append((*predictor._fetch_async(out, d2h, device),
                                {k for k, v in out.items() if torch.is_tensor(v) and v.ndim}))
        return fetched

    @staticmethod
    def join(fetched: List[tuple]) -> Dict[str, Any]:
        """The replicas' outputs as numpy, one batch in row order."""
        outs = [_host_numpy(done, host) for done, host, _ in fetched]
        if len(outs) == 1:
            return outs[0]
        row_keys = fetched[0][2]
        return {k: np.concatenate([o[k] for o in outs]) if k in row_keys else first
                for k, first in outs[0].items()}


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
        # Set by from_model_paths(host_resize=True): (scale, max_height,
        # max_width), the resize moved from the device to the host.
        self._host_transform = None
        # Set by run.predict: what a centroid model's frames hold
        # ("instance", "centroid" or "both") and the provider's decode
        # queue depth in batches (None: the provider's default).
        self.centroid_output = "instance"
        self.prefetch_batches: Optional[int] = None
        # Set by run.predict(only_labeled_frames=True): ground-truth
        # centroids come from user instances only.
        self.gt_user_instances_only = False
        self.last_stats: Dict[str, float] = {}
        # Set by from_model_paths: a segmentation model's frames keep their
        # masks ("mask"), their outlines ("polygon") or both ("both"),
        # outlines simplified by polygon_epsilon of their perimeter.
        self.mask_output = "mask"
        self.polygon_epsilon = 0.01
        # The devices of the replicas and their layers (``replicas[0]`` is
        # ``layer``): one unless from_model_paths(data_parallel=...).
        self.mesh: List[torch.device] = [self.device]
        self.replicas: List = [layer]

    # -- construction ---------------------------------------------------------
    @classmethod
    def from_model_paths(
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
        host_resize: bool = False,
        centroid_only: bool = False,
        backbone_ckpt_path: Optional[Union[str, Path]] = None,
        head_ckpt_path: Optional[Union[str, Path]] = None,
        anchor_part: Optional[str] = None,
        merge_fragments: bool = False,
        merge_method: str = "greedy",
        min_mask_area: int = 0,
        fg_threshold: float = 0.5,
        center_nms_kernel: int = 3,
        distance_gate_alpha: Optional[float] = None,
        mask_cleanup: bool = True,
        mask_cleanup_radius: int = 0,
        merge_dilate: int = 1,
        merge_w_valley: float = 1.0,
        merge_w_offset: float = 0.25,
        merge_thresholds: Sequence[float] = (0.85, 0.6, 0.4),
        full_res_masks: bool = False,
        mask_output: str = "mask",
        polygon_epsilon: float = 0.01,
        data_parallel: Union[bool, Sequence] = False,
        device="cuda",
        **unported,
    ) -> "Predictor":
        """Load the model dirs and build the layer of their type set:
        ``{single_instance}``, ``{centroid}``, ``{centroid,
        centered_instance}`` (top-down), ``{centered_instance}`` (on the
        ground-truth centroids of a labels source, at the ``anchor_part``
        node where it is visible) or ``{bottomup}``; identity models:
        ``{multi_class_bottomup}`` and ``{centroid, multi_class_topdown}``;
        segmentation models: ``{bottomup_segmentation}`` (with the
        ``merge_*``, ``min_mask_area``, ``fg_threshold``,
        ``center_nms_kernel``, ``distance_gate_alpha``, ``mask_cleanup*``
        and ``full_res_masks`` knobs; ``max_instances`` 50 by default),
        ``{semantic_segmentation}`` and ``{centroid,
        centered_instance_segmentation}``. ``mask_output`` and
        ``polygon_epsilon`` set what a segmentation model's frames hold.
        The segmentation knobs do nothing for the other types, as in the
        JAX package.

        ``backbone_ckpt_path`` / ``head_ckpt_path`` swap in the backbone /
        head weights of another model dir. The preprocessing overrides
        trump each model's training config. ``centroid_only`` keeps only
        the centroid model. ``host_resize`` moves the sizematcher and the
        scale to the host (cv2 ``INTER_AREA``, before the copy to the
        device), for the keypoint type sets on full frames whose stages
        preprocess alike. The layers run on ``device`` (the card unless
        ``"cpu"``); the fused double-conv kernel runs there on a card.

        ``data_parallel=True`` builds one replica of every backend and
        layer on each CUDA device this process sees (one on the CPU), or
        on each device of a list (``parallel.get_mesh(devices=...)``; a
        device may repeat). Each batch splits into contiguous rows, one
        block a replica, and the outputs join in row order before the
        host step; ``batch_size`` must divide by the replica count. One
        host thread enqueues every replica's work, which makes several
        cards slower than one today."""
        refuse_unported(unported, UNPORTED_KNOBS, "from_model_paths")
        device = resolve_device(device)
        loaded = [load_model(p) for p in model_paths]
        if backbone_ckpt_path or head_ckpt_path:
            _swap_param_subtrees(loaded, backbone_ckpt_path, head_ckpt_path)
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
        if centroid_only:
            loaded = [m for m in loaded if m.model_type == "centroid"]
            if not loaded:
                raise ValueError("--centroid-only requires a centroid model.")
        by_type: Dict[str, LoadedModel] = {}
        for m in loaded:
            if m.model_type in by_type:
                raise ValueError(
                    f"Duplicate model type {m.model_type!r} in model_paths; "
                    "pass at most one checkpoint per model type."
                )
            by_type[m.model_type] = m
        types = set(by_type)
        host_transform = _move_resize_to_host(loaded, types) if host_resize else None

        def build(device):
            """The layer of the type set, on ``device``."""
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

            def centroid_stage() -> CentroidLayer:
                """The top-down pair's centroid layer."""
                mc = by_type["centroid"]
                post_c = post_for()
                post_c.max_instances = max_instances or 20
                if centroid_peak_threshold is not None:
                    post_c.peak_threshold = centroid_peak_threshold
                return CentroidLayer(
                    backend_for(mc), _pre_config(mc), post_c,
                    output_stride=get_head_config(mc.config).confmaps.output_stride, device=device)

            def topdown_stages(mi):
                """The centroid layer and the centered-instance layer of ``mi``,
                with its crop size."""
                centroid_layer = centroid_stage()
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
                return _Built(layer, "single_instance", m)

            if types == {"centroid"}:
                m = by_type["centroid"]
                layer = CentroidLayer(
                    backend_for(m), _pre_config(m), post_for(),
                    output_stride=get_head_config(m.config).confmaps.output_stride, device=device)
                return _Built(layer, "centroid", m, skeleton=Skeleton(nodes=["centroid"]))

            if types == {"centroid", "centered_instance"}:
                mi = by_type["centered_instance"]
                return _Built(TopDownLayer(**topdown_stages(mi)), "topdown", mi)

            if types == {"centroid", "multi_class_topdown"}:
                mi = by_type["multi_class_topdown"]
                classes = list(get_head_config(mi.config).class_vectors.classes)
                layer = TopDownMultiClassLayer(**topdown_stages(mi), n_classes=len(classes))
                return _Built(layer, "multi_class_topdown", mi, classes)

            if types == {"multi_class_bottomup"}:
                m = by_type["multi_class_bottomup"]
                head = get_head_config(m.config)
                classes = list(head.class_maps.classes)
                layer = BottomUpMultiClassLayer(
                    backend_for(m), _pre_config(m), post_for(),
                    n_nodes=len(head.confmaps.part_names), n_classes=len(classes),
                    cm_output_stride=head.confmaps.output_stride,
                    class_maps_output_stride=head.class_maps.output_stride, device=device)
                return _Built(layer, "multi_class_bottomup", m, classes)

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
                return _Built(layer, "bottomup", m)

            if types == {"centered_instance"}:
                mi = by_type["centered_instance"]
                inst_pre = _pre_config(mi)
                instance_layer = CenteredInstanceLayer(
                    backend_for(mi), inst_pre, post_for(),
                    output_stride=get_head_config(mi.config).confmaps.output_stride, device=device)
                layer = GTCentroidTopDownLayer(
                    instance_layer, max_instances=max_instances or 20,
                    crop_size=_crop_size(mi, crop_size, inst_pre), device=device)
                if anchor_part is not None:
                    nodes = list(mi.skeleton_nodes)
                    if anchor_part not in nodes:
                        raise ValueError(
                            f"anchor_part {anchor_part!r} is not a skeleton node; nodes: {nodes}.")
                    layer.anchor_ind = nodes.index(anchor_part)
                return _Built(layer, "topdown", mi)

            if types == {"centroid", "centered_instance_segmentation"}:
                ms = by_type["centered_instance_segmentation"]
                seg_pre = _pre_config(ms)
                layer = TopDownSegmentationLayer(
                    centroid_stage(), backend_for(ms), seg_pre,
                    seg_output_stride=get_head_config(ms.config).segmentation.output_stride,
                    fg_threshold=fg_threshold, max_instances=max_instances or 20,
                    crop_size=_crop_size(ms, crop_size, seg_pre,
                                         "centered_instance_segmentation"),
                    device=device)
                return _Built(layer, "topdown_segmentation", ms,
                              skeleton=Skeleton(nodes=["centroid"]))

            if types == {"bottomup_segmentation"}:
                m = by_type["bottomup_segmentation"]
                head = get_head_config(m.config)
                layer = BottomUpSegmentationLayer(
                    backend_for(m), _pre_config(m), post_for(),
                    seg_output_stride=head.segmentation.output_stride,
                    center_output_stride=head.center.output_stride,
                    offsets_output_stride=head.offsets.output_stride,
                    max_instances=max_instances or 50, min_mask_area=min_mask_area,
                    merge_fragments=merge_fragments, merge_method=merge_method,
                    fg_threshold=fg_threshold, center_nms_kernel=center_nms_kernel,
                    distance_gate_alpha=distance_gate_alpha, mask_cleanup=mask_cleanup,
                    mask_cleanup_radius=mask_cleanup_radius, merge_dilate=merge_dilate,
                    merge_w_valley=merge_w_valley, merge_w_offset=merge_w_offset,
                    merge_thresholds=merge_thresholds, full_res_masks=full_res_masks,
                    device=device)
                return _Built(layer, "bottomup_segmentation", m,
                            skeleton=Skeleton(nodes=["centroid"]))

            if types == {"semantic_segmentation"}:
                m = by_type["semantic_segmentation"]
                layer = SemanticSegmentationLayer(
                    backend_for(m), _pre_config(m), post_for(),
                    seg_output_stride=get_head_config(m.config).segmentation.output_stride,
                    fg_threshold=fg_threshold, full_res_masks=full_res_masks, device=device)
                return _Built(layer, "semantic_segmentation", m, skeleton=Skeleton(nodes=["fg"]))
            raise ValueError(f"Unsupported model type combination: {sorted(types)}")

        mesh = [device]
        if data_parallel:
            # One replica of every backend and layer a device of the mesh,
            # each predicting its contiguous rows of every batch.
            mesh = get_mesh(devices=None if data_parallel is True else data_parallel,
                            device=device)
            if batch_size % len(mesh) != 0:
                raise ValueError(
                    f"data_parallel inference needs batch_size divisible "
                    f"by the device count: batch_size={batch_size}, "
                    f"devices={len(mesh)}.")
            mesh = [resolve_device(d) for d in mesh]
            device = mesh[0]
        built = build(device)
        p = cls(built.layer, built.model_type,
                built.skeleton or Skeleton(nodes=built.model.skeleton_nodes,
                                           edges=built.model.skeleton_edges),
                loaded, batch_size, device=device, paf_workers=paf_workers, filters=filters)
        p.class_names = built.class_names
        p._host_transform = host_transform
        p.mask_output = mask_output
        p.polygon_epsilon = polygon_epsilon
        p.mesh = mesh
        p.replicas = [built.layer] + [r.layer for r in replicate(build, mesh[1:])]
        logger.info("Loaded inference model | " + " | ".join([
            f"type={'+'.join(m.model_type for m in loaded)}",
            f"backbone={get_backbone_type_from_cfg(loaded[0].config)}",
            f"nodes={len(p.skeleton.nodes)}",
            f"device={device}",
            f"replicas={len(mesh)}",
            f"batch_size={batch_size}",
            f"peak_threshold={peak_threshold}",
            f"max_instances={max_instances}",
            f"integral_refinement={refinement}",
            f"paf_workers={paf_workers}",
        ]))
        return p

    # -- prediction -----------------------------------------------------------
    def _scoped_postprocess_layer(self, layer=None, **overrides):
        """The layer (the predictor's, or ``layer``) with the given
        ``return_confmaps`` / ``return_paf_graph`` (None: as built): a
        shallow copy of it and of its stage layers, sharing their backends,
        with post configs of their own; the layer itself when nothing
        changes. So concurrent calls on one predictor cannot clobber each
        other."""
        layer = self.layer if layer is None else layer
        stages = [n for n in ("centroid_layer", "instance_layer") if hasattr(layer, n)]
        posts = [getattr(layer, n).post for n in stages]
        if hasattr(layer, "post"):
            posts.append(layer.post)
        overrides = {k: bool(v) for k, v in overrides.items()
                     if v is not None and any(getattr(p, k) != bool(v) for p in posts)}
        if not overrides:
            return layer
        scoped = copy.copy(layer)
        for name in stages:
            stage = copy.copy(getattr(scoped, name))
            stage.post = dataclasses.replace(stage.post, **overrides)
            setattr(scoped, name, stage)
        if hasattr(scoped, "post"):
            scoped.post = dataclasses.replace(scoped.post, **overrides)
        return scoped

    def _make_provider(self, data, frames=None):
        """A ``LabelsProvider`` of a ``Labels`` or ``.slp`` path, else a
        ``VideoProvider`` of a video file by name or a video object, which
        decodes to one channel for a grayscale model. ``prefetch_batches``
        sets the decode queue's depth. A layer on ground-truth centroids
        gets them from the labels provider and refuses a video."""
        needs_gt = getattr(self.layer, "needs_gt_centroids", False)
        is_slp = isinstance(data, (str, Path)) and str(data).endswith(".slp")
        if (isinstance(data, Labels) or is_slp) and frames is not None:
            raise ValueError("frames selects frames of a video; a Labels source predicts its "
                             "labeled frames (run.predict's only_suggested_frames predicts "
                             "its suggestions)")
        kw = {"batch_size": self.batch_size}
        if self.prefetch_batches:
            kw["prefetch"] = int(self.prefetch_batches)
        if is_slp:
            from sleap_nn_tpu_torch.io.slp import load_slp

            data = load_slp(data)
        if isinstance(data, Labels):
            if needs_gt:
                kw.update(with_centroids=True, max_instances=self.layer.max_instances,
                          anchor_ind=self.layer.anchor_ind,
                          user_frames_only=self.gt_user_instances_only)
            return LabelsProvider(data, **kw)
        if needs_gt and isinstance(data, (str, Path)):
            raise ValueError(
                "Centered-instance-only inference uses GROUND-TRUTH centroids and needs a "
                ".slp source (a video has none); pair the model with a centroid model for "
                "videos.")
        if needs_gt:
            raise ValueError("Centered-instance-only inference needs a .slp source.")
        return VideoProvider(str(data) if isinstance(data, Path) else data, frames=frames,
                             out_format="gray" if self._host_grayscale else None, **kw)

    def _host_step(self, batch):
        """What the host does to a batch before its copy to the device, on
        the provider's decode thread: RGB to gray for a grayscale model,
        then the resize moved to the host. Returns ``(batch, frames,
        factor)``: coordinates found on ``frames`` divide by ``factor``."""
        frames = batch.frames
        if self._host_grayscale and frames.shape[-1] == 3:
            frames = rgb_to_gray_uint8(frames)
        factor = 1.0
        if self._host_transform is not None:
            frames, factor = self._apply_host_resize(frames)
        return batch, frames, factor

    def _apply_host_resize(self, frames: np.ndarray):
        """Sizematcher and scale on the host (cv2 ``INTER_AREA``), rounded as
        the device's ``apply_sizematcher`` and ``resize_image`` round;
        returns (frames, the factor that lifts coordinates back)."""
        import cv2

        scale, mh, mw = self._host_transform
        b, h, w, c = frames.shape
        eff = 1.0
        if (mh or mw) and (h, w) != (mh or h, mw or w):
            # An unset dimension constrains nothing, as on the device.
            eff = min((mh or h) / h, (mw or w) / w)
        th, tw = int(round(h * eff)), int(round(w * eff))
        th2, tw2 = int(round(th * scale)), int(round(tw * scale))
        if (th2, tw2) == (h, w):
            return frames, 1.0
        out = np.empty((b, th2, tw2, c), dtype=frames.dtype)
        for i in range(b):
            r = cv2.resize(frames[i], (tw2, th2), interpolation=cv2.INTER_AREA)
            out[i] = r[..., None] if r.ndim == 2 else r
        return out, eff * scale

    @staticmethod
    def _lift_host_coords(out: Dict, factor: float) -> Dict:
        """Coordinates found on host-resized frames -> the original frames."""
        if factor == 1.0:
            return out
        for key in ("pred_keypoints", "pred_centroids"):
            val = out.get(key)
            if val is None:
                continue
            if isinstance(val, list):
                out[key] = [np.asarray(v) / factor for v in val]
            else:
                out[key] = np.asarray(val) / factor
        graphs = out.get("pred_paf_graph")
        if graphs is not None:  # its peaks live where the instances do
            out["pred_paf_graph"] = [(np.asarray(peaks) / factor, e, ep, ls)
                                     for peaks, e, ep, ls in graphs]
        return out

    def _send(self, frames: np.ndarray, h2d, device: torch.device) -> torch.Tensor:
        """Host frames -> ``device``, through pinned memory on the copy
        stream, for that device's current stream."""
        host = torch.from_numpy(np.ascontiguousarray(frames))
        if h2d is None:
            return host.to(device)
        host = host.pin_memory()
        compute = torch.cuda.current_stream(device)
        with torch.cuda.stream(h2d):
            dev = host.to(device, non_blocking=True)
        compute.wait_stream(h2d)
        dev.record_stream(compute)
        return dev

    def _fetch_async(self, out: Dict[str, Any], d2h, device: torch.device):
        """Enqueue device -> pinned host copies after ``device``'s current
        stream; returns (event or None, host dict).

        bf16 tensors come back as f32 (exact): numpy has no bfloat16.
        """
        if d2h is None:
            return None, to_host(out)
        d2h.wait_stream(torch.cuda.current_stream(device))
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
                make_labels: bool = True, provider=None,
                return_confmaps: Optional[bool] = None,
                return_paf_graph: Optional[bool] = None):
        """Run inference over a frame source: a ``Labels``, a ``.slp`` path,
        a video file's path, or a video (an object with ``__len__`` and
        ``get_frame(idx, fmt)``).

        With ``make_labels`` returns ``Labels``; else the per-batch output
        dicts, each holding the layer's outputs as numpy plus
        ``frame_inds``, ``video_inds`` and ``valid`` (False on the padded
        rows of a short last batch). ``return_confmaps`` /
        ``return_paf_graph`` override the construction's flags for this
        call only, on a layer of its own: the predictor is not changed.
        """
        scoped_layer = self._scoped_postprocess_layer(return_confmaps=return_confmaps,
                                                      return_paf_graph=return_paf_graph)
        if scoped_layer is not self.layer:
            scoped = copy.copy(self)
            scoped.layer = scoped_layer
            scoped.replicas = [scoped_layer] + [
                self._scoped_postprocess_layer(r, return_confmaps=return_confmaps,
                                               return_paf_graph=return_paf_graph)
                for r in self.replicas[1:]]
            return scoped.predict(data, frames, make_labels, provider)
        provider = provider or self._make_provider(data, frames)
        videos = self._provider_videos(provider)
        if videos:
            # As the JAX predictor's start log does: reading the first
            # video's shape lets a media video find that its content is
            # gray, and its frames then decode to one channel.
            getattr(videos[0], "shape", None)
        writer = self.stream_writer
        stream_frames: List[LabeledFrame] = []
        cuda = self.device.type == "cuda"
        h2d = torch.cuda.Stream(self.device) if cuda else None
        d2h = torch.cuda.Stream(self.device) if cuda else None
        replicas = _Replicas(self.replicas, self.mesh, h2d, d2h)
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

        def emit(out, batch, factor):
            nonlocal n_frames
            out = self._lift_host_coords(out, factor)
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
                    fetched, batch, factor = item
                    out = replicas.join(fetched)  # one batch again, before the host step
                    if pool is None:
                        emit(self.layer.postprocess_host(out), batch, factor)
                        continue
                    pool.submit(len(pool_batches), self.layer.host_payload(out))
                    pool_batches.append((batch, factor))
                    if len(pool) > 2 * self.paf_workers:  # bound the backlog
                        ordinal, grouped = pool.drain_one()
                        emit(grouped, *pool_batches[ordinal])
                except Exception as e:  # raised again on the main thread
                    errors.append(e)

        t0 = time.perf_counter()
        with pool if pool is not None else contextlib.nullcontext():
            thread = threading.Thread(target=fetcher, name="sleap-nn-torch-fetch", daemon=True)
            thread.start()
            batches = provider.batches(self._host_step)
            try:
                for batch, frames_b, factor in batches:
                    if errors:
                        break
                    arrays = [frames_b]
                    if getattr(self.layer, "needs_gt_centroids", False):
                        # The centroids of every row, padded ones too.
                        arrays += [batch.gt_centroids, batch.gt_centroid_valid,
                                   batch.gt_centroid_vals]
                    fetch_q.put((replicas.enqueue(self, arrays), batch, factor))
            finally:
                fetch_q.put(None)
                thread.join()
                if hasattr(batches, "close"):
                    batches.close()
            if errors:
                raise errors[0]
            if pool is not None:
                for ordinal, grouped in pool.iter_completed():
                    emit(grouped, *pool_batches[ordinal])
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
        seg = self.model_type in SEGMENTATION_TYPES
        self._log_inference_summary(
            sum(len(lf.masks) if seg else len(lf.instances) for lf in labels.labeled_frames),
            "masks" if seg else "instances")
        return labels

    def _log_inference_summary(self, n_objects: Optional[int] = None,
                               object_label: str = "instances") -> None:
        """One log line after a run: frames, instances (a segmentation
        model's masks), time, frames/s and whether the Labels will be
        tracked."""
        s = self.last_stats
        parts = [f"frames={s['n_frames']}"]
        if n_objects is not None:
            mean = n_objects / s["n_frames"] if s["n_frames"] else 0.0
            parts.append(f"{object_label}={n_objects} ({mean:.2f}/frame)")
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
            frame_idx = int(out["frame_inds"][i])
            if self.model_type in SEGMENTATION_TYPES:
                # Masks, not filtered; a bottom-up model's frames also hold
                # its centres as one-node instances.
                instances = []
                if self.model_type == "bottomup_segmentation":
                    cents, vals = out["pred_centroids"][i], out["centroid_vals"][i]
                    valid = out["centroid_valid"][i]
                    for k in range(cents.shape[0]):
                        if valid[k] and not np.all(np.isnan(cents[k])):
                            instances.append(
                                self._make_instance(cents[k][None], vals[k:k + 1], skel))
                masks = out["pred_masks"][i]
                if masks or instances:
                    lf = LabeledFrame(video=vid, frame_idx=frame_idx, instances=instances,
                                      masks=masks)
                    self._apply_mask_output(lf, out.get("mask_scale", 1.0))
                    lfs.append(lf)
                continue
            instances = []
            if self.model_type == "single_instance":
                pts, vals = out["pred_keypoints"][i], out["pred_peak_values"][i]
                for k in range(pts.shape[0]):
                    if not np.all(np.isnan(pts[k])):
                        instances.append(self._make_instance(pts[k], vals[k], skel))
            elif self.model_type == "centroid":
                # centroid_output: "instance" gives one-node instances,
                # "centroid" PredictedCentroid records, "both" both.
                cents, vals = out["pred_centroids"][i], out["centroid_vals"][i]
                valid = out["centroid_valid"][i]
                frame_centroids = []
                for k in range(cents.shape[0]):
                    if not valid[k] or np.all(np.isnan(cents[k])):
                        continue
                    if self.centroid_output in ("instance", "both"):
                        instances.append(self._make_instance(cents[k][None], vals[k:k + 1], skel))
                    if self.centroid_output in ("centroid", "both"):
                        frame_centroids.append(PredictedCentroid(cents[k], score=float(vals[k])))
                if frame_centroids:  # kept as found: the instance filters skip such frames
                    lfs.append(LabeledFrame(video=vid, frame_idx=int(out["frame_inds"][i]),
                                            instances=instances, centroids=frame_centroids))
                    continue
            elif self.model_type == "topdown":
                pts, vals = out["pred_keypoints"][i], out["pred_peak_values"][i]
                valid = out["instance_valid"][i]
                # Ground-truth centroids carry their source's score as the
                # instance score; a centroid model's runs score by the
                # mean peak value.
                scores = out.get("pred_instance_scores")
                for k in range(pts.shape[0]):
                    if valid[k] and not np.all(np.isnan(pts[k])):
                        instances.append(self._make_instance(
                            pts[k], vals[k], skel,
                            score=None if scores is None else float(scores[i][k])))
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

    def _apply_mask_output(self, lf: LabeledFrame, mask_scale: float = 1.0) -> None:
        """``mask_output`` on one frame: ``"polygon"`` and ``"both"`` add
        each mask's outline (``mask_to_polygon`` at ``polygon_epsilon``, in
        image pixels by the mask's ``scale``, else ``mask_scale``) as a
        ``PredictedROI``; ``"polygon"`` then drops the masks."""
        if self.mask_output == "mask" or not lf.masks:
            return
        rois = []
        for sm in lf.masks:
            poly = mask_to_polygon(sm.mask, epsilon_frac=float(self.polygon_epsilon),
                                   scale=getattr(sm, "scale", None) or mask_scale)
            if poly is not None:
                rois.append(PredictedROI(poly, score=sm.score, track=sm.track))
        lf.rois = rois
        if self.mask_output == "polygon":
            lf.masks = []

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


class ExportedLayer:
    """A layer over a loaded export (``export.load_exported_model``): the
    program holds the device work; the host step is the layer type's own.

    ``predict_async`` pads a short batch to the baked batch size (repeating
    its last frame), matches the baked channel count and calls the
    program; ``postprocess_host`` drops the padded rows, then runs
    ``finalize_fn`` (the host half of the model type) or, for
    single-instance and bottom-up programs, the live layers' host step.
    """

    def __init__(self, call, meta, device="cuda", paf_scorer=None,
                 max_instances: Optional[int] = None, finalize_fn=None):
        self.call = call
        self.meta = meta
        self.device = resolve_device(device)
        self.batch_size = int(meta.input_shape[0])
        self.paf_scorer = paf_scorer
        self.max_instances = max_instances
        self.finalize_fn = finalize_fn

    def predict_async(self, images) -> Dict[str, Any]:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        b, tb = images.shape[0], self.batch_size
        if b > tb:
            raise ValueError(f"Exported model compiled for batch {tb}; got {b}. "
                             "Use batch_size <= the exported batch.")
        pad = tb - b
        if pad:
            images = torch.cat([images, images[-1:].expand(pad, *images.shape[1:])])
        want_c = self.meta.input_shape[-1]
        if images.shape[-1] == 3 and want_c == 1:
            images = torch.from_numpy(rgb_to_gray_uint8(images.cpu().numpy().astype(np.uint8)))
        elif images.shape[-1] == 1 and want_c == 3:
            images = images.expand(*images.shape[:-1], 3)
        out = dict(self.call(images.to(self.device, torch.uint8).contiguous()))
        out["_pad"] = pad
        return out

    def postprocess_host(self, host: Dict[str, Any]) -> Dict[str, Any]:
        pad = host.pop("_pad", 0)
        out = {k: v[: len(v) - pad] if pad and np.ndim(v) else v for k, v in host.items()}
        if self.finalize_fn is not None:
            return self.finalize_fn(out)
        if self.meta.model_type == "single_instance":
            out["pred_keypoints"] = out["pred_keypoints"][:, None]
            out["pred_peak_values"] = out["pred_peak_values"][:, None]
        elif self.meta.model_type == "bottomup":
            # The program holds the dense PAF scoring; the host grouping of
            # the live BottomUpLayer runs here (peaks in original coords).
            out = group_batch_host({"grouped_peaks": out["grouped_peaks"],
                                    "grouped_vals": out["grouped_vals"],
                                    "scores": out["paf_scores"], "lift": 1.0},
                                   self.paf_scorer, self.max_instances)
        return out

    def finalize(self, device_out: Dict[str, Any]) -> Dict[str, Any]:
        return self.postprocess_host(to_host(device_out))

    def predict(self, images) -> Dict[str, Any]:
        return self.finalize(self.predict_async(images))


def from_export_dir(export_dir, batch_size: Optional[int] = None,
                    max_instances: Optional[int] = None, min_line_scores: float = 0.25,
                    runtime: str = "auto", device="cuda") -> Predictor:
    """A ``Predictor`` over an export dir's program (``model.pt2``), run on
    ``device`` (the card unless ``"cpu"``).

    Every exported model type but the crop models: single-instance,
    centroid (with its ``anchor_part``), bottom-up (the host grouping
    rebuilt from the copied ``training_config.yaml``), multi-class
    bottom-up, the topdown and multi-class topdown composites, semantic
    and bottom-up segmentation. Centered-instance and centered-instance
    segmentation exports run on crops cut beforehand and raise
    ``NotImplementedError``: export the topdown composite instead.
    """
    import types

    from sleap_nn_tpu_torch.config import TrainingJobConfig
    from sleap_nn_tpu_torch.export import load_exported_model

    device = resolve_device(device)
    call, meta = load_exported_model(export_dir, runtime=runtime, device=device)
    skel = Skeleton(nodes=list(meta.skeleton_nodes) or ["centroid"],
                    edges=list(meta.skeleton_edges))

    def load_cfg() -> TrainingJobConfig:
        cfg_path = Path(export_dir) / "training_config.yaml"
        if not cfg_path.exists():
            raise FileNotFoundError(
                f"{meta.model_type} export needs its training_config.yaml for host-side "
                f"postprocessing; not found under {export_dir}.")
        return TrainingJobConfig.load_yaml(str(cfg_path))

    def make(layer, model_type, skeleton=skel, class_names=None) -> Predictor:
        p = Predictor(layer, model_type, skeleton, [], batch_size or layer.batch_size,
                      device=device)
        p.class_names = class_names
        p._host_grayscale = meta.input_shape[-1] == 1
        return p

    mt = meta.model_type
    if mt == "bottomup":
        head = get_head_config(load_cfg())
        scorer = PAFScorer(part_names=head.confmaps.part_names,
                           edges=[tuple(e) for e in head.pafs.edges],
                           pafs_stride=head.pafs.output_stride, min_line_scores=min_line_scores)
        return make(ExportedLayer(call, meta, device, paf_scorer=scorer,
                                  max_instances=max_instances), "bottomup")

    if mt == "multi_class_bottomup":
        head = get_head_config(load_cfg())
        n_nodes, n_classes = len(head.confmaps.part_names), len(head.class_maps.classes)

        def finalize_mcbu(out):
            b, k = out["vals"].shape
            valid = out["valid"].reshape(-1)
            pts_g, vals_g, probs_g = group_and_assemble(
                out["points_grid"].reshape(-1, 2)[valid], out["vals"].reshape(-1)[valid],
                np.repeat(np.arange(b), k)[valid], out["channels"].reshape(-1)[valid],
                out["class_probs"].reshape(-1, n_classes)[valid], b, n_classes, n_nodes,
                sort_keys=out["rough"].reshape(-1, 2)[valid])
            return {"pred_keypoints": pts_g * out["lift"].reshape(b, 1, 1, 1),
                    "pred_peak_values": vals_g, "pred_class_probs": probs_g}

        return make(ExportedLayer(call, meta, device, finalize_fn=finalize_mcbu),
                    "multi_class_bottomup", class_names=list(head.class_maps.classes))

    if mt in ("topdown", "multi_class_topdown"):
        if mt == "topdown":
            return make(ExportedLayer(call, meta, device), "topdown")
        classes = list(get_head_config(load_cfg()).class_vectors.classes)
        # The live layer's host step reads only the outputs.
        layer = ExportedLayer(call, meta, device, finalize_fn=lambda out: (
            TopDownMultiClassLayer.postprocess_host(None, out)))
        return make(layer, "multi_class_topdown", class_names=classes)

    if mt in ("semantic_segmentation", "bottomup_segmentation"):
        cfg = load_cfg()
        head = get_head_config(cfg)
        # The live layer's grid-to-image context: the head's stride and the
        # baked preprocessing scale.
        shim = types.SimpleNamespace(
            seg_output_stride=head.segmentation.output_stride, fg_threshold=0.5,
            pre=types.SimpleNamespace(scale=cfg.data_config.preprocessing.scale or 1.0),
            full_res_masks=False, min_mask_area=0, merge_fragments=False,
            merge_method="greedy", do_mask_cleanup=True, mask_cleanup_radius=0)
        layer_cls = (SemanticSegmentationLayer if mt == "semantic_segmentation"
                     else BottomUpSegmentationLayer)
        layer = ExportedLayer(call, meta, device,
                              finalize_fn=lambda out: layer_cls.postprocess_host(shim, out))
        nodes = ["fg"] if mt == "semantic_segmentation" else ["centroid"]
        return make(layer, mt, skeleton=Skeleton(nodes=nodes))

    if mt in ("centered_instance", "centered_instance_segmentation"):
        raise NotImplementedError(
            f"from_export_dir does not support {mt!r} (centered-instance-style exports run "
            "on pre-extracted crops; export the topdown composite instead).")
    if mt not in ("single_instance", "centroid"):
        raise ValueError(
            f"Unrecognized model_type {mt!r} in this export dir's metadata.json — not a "
            "model type this framework exports.")
    layer = ExportedLayer(call, meta, device)
    if mt == "single_instance":
        return make(layer, mt)
    # The node that anchored the training centroids; one missing from the
    # node list marks a corrupt export.
    anchor = meta.anchor_part
    if anchor is not None:
        nodes = list(meta.skeleton_nodes)
        if anchor not in nodes:
            raise ValueError(f"export metadata anchor_part {anchor!r} not found in skeleton "
                             f"nodes {nodes}.")
        layer.anchor_ind = nodes.index(anchor)
    # One point per instance: the one-node skeleton of the live predictor.
    return make(layer, mt, skeleton=Skeleton(nodes=["centroid"]))


Predictor.from_export_dir = staticmethod(from_export_dir)
