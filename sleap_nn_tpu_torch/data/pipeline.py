"""Training data pipeline: host datasets, the loader and the device render.

Port of ``sleap_nn_tpu/data/pipeline.py`` for single-instance, centroid,
centered-instance, bottom-up and identity (multi-class bottom-up and
top-down) models. The host side indexes labeled
frames, decodes and NaN-pads them (numpy); the render function built by
:func:`make_render_fn` runs on the training device under
``torch.no_grad()``: normalize, channels, sizematch, scale, augment, pad to
stride, then the model type's targets: confidence maps (the centroid and
bottom-up maps through kernel 4 on CUDA), instance crops, part affinity
fields, class maps and class vectors.

Not ported yet: the render and datasets of the segmentation and tiled
model types (they raise ``NotImplementedError``), the disk cache, negative
frames and user-centroid samples.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from sleap_nn_tpu_torch.data.augmentation import (
    apply_geometric_augmentation,
    apply_intensity_augmentation,
)
from sleap_nn_tpu_torch.data.identity import generate_class_maps, make_class_vectors
from sleap_nn_tpu_torch.data.instance_centroids import generate_centroids
from sleap_nn_tpu_torch.data.instance_cropping import (
    compute_augmentation_padding,
    find_instance_crop_size,
    generate_crops,
)
from sleap_nn_tpu_torch.data.normalization import apply_channel_config, normalize_image
from sleap_nn_tpu_torch.data.providers import get_max_instances, process_lf
from sleap_nn_tpu_torch.data.resizing import apply_pad_to_stride, apply_resizer, apply_sizematcher
from sleap_nn_tpu_torch.io.model import Labels
from sleap_nn_tpu_torch.ops.confmaps import generate_confmaps, generate_multiconfmaps
from sleap_nn_tpu_torch.ops.edge_maps import generate_pafs

# Model types of the JAX package that the port does not train yet, and the
# ROADMAP.md section 1 item that ports each.
_UNPORTED_TYPES = {
    "bottomup_segmentation": 10, "semantic_segmentation": 10,
    "centered_instance_segmentation": 10,
}
# Model types trained on crops around one instance.
CROP_TYPES = ("centered_instance", "multi_class_topdown")


def _unported(what: str, model_type: str) -> NotImplementedError:
    item = _UNPORTED_TYPES.get(model_type)
    where = f" (ROADMAP.md section 1, item {item})" if item else ""
    return NotImplementedError(f"the {what} of {model_type!r} models is not ported yet{where}")


@dataclasses.dataclass
class PipelineContext:
    """Static pipeline parameters shared by host datasets and the device render."""

    model_type: str
    n_nodes: int
    max_instances: int
    edge_inds: Tuple[Tuple[int, int], ...] = ()
    n_classes: int = 0
    # preprocessing
    ensure_rgb: bool = False
    ensure_grayscale: bool = False
    max_height: Optional[int] = None
    max_width: Optional[int] = None
    scale: float = 1.0
    crop_size: Optional[int] = None
    max_stride: int = 16
    # heads
    sigma: float = 5.0
    output_stride: int = 2
    pafs_sigma: float = 15.0
    pafs_output_stride: int = 4
    class_maps_sigma: float = 5.0
    class_maps_output_stride: int = 2
    anchor_ind: Optional[int] = None
    # augmentation
    use_augmentations: bool = False
    intensity: Optional[dict] = None
    geometric: Optional[dict] = None
    symmetric_inds: Tuple[Tuple[int, int], ...] = ()


def _aug_kwargs(cfg) -> dict:
    if cfg is None:
        return {}
    if dataclasses.is_dataclass(cfg):
        return dataclasses.asdict(cfg)
    return dict(cfg)


def preprocess_batch(
    ctx: PipelineContext,
    image: torch.Tensor,
    instances: torch.Tensor,
    generator: Optional[torch.Generator],
    train: bool,
) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """normalize -> channels -> sizematch -> scale -> augment (not yet padded
    to stride). Returns ``(image, instances, eff_scale)``."""
    image = normalize_image(image)
    image = apply_channel_config(image, ctx.ensure_rgb, ctx.ensure_grayscale)
    image, eff_scale = apply_sizematcher(image, ctx.max_height, ctx.max_width)
    instances = instances * eff_scale
    image, instances = apply_resizer(image, instances, ctx.scale)

    if train and ctx.use_augmentations and generator is not None:
        if ctx.intensity:
            image = apply_intensity_augmentation(generator, image, **ctx.intensity)
        if ctx.geometric:
            image, instances = apply_geometric_augmentation(
                generator, image, instances, symmetric_inds=ctx.symmetric_inds or None,
                **ctx.geometric)
    return image, instances, eff_scale


def make_render_fn(ctx: PipelineContext, train: bool) -> Callable:
    """Build the device-side ``batch -> {inputs, targets}`` function.

    The returned ``fn(batch, generator=None)`` takes a dict of tensors on the
    training device (``image`` uint8 ``(B, H, W, C)``, ``instances``
    ``(B, I, N, 2)``, ``center_idx`` ``(B,)`` for crop models and
    ``track_ids`` ``(B, I)`` for identity models) and returns, under
    ``torch.no_grad()``, ``image`` (the network input), ``instances``,
    ``eff_scale`` and the model type's targets:

    - ``single_instance``: ``confmaps`` of the first instance;
    - ``centroid``: ``centroids`` ``(B, I, 2)`` and ``confmaps``
      ``(B, H/s, W/s, 1)`` (kernel 4 on CUDA);
    - ``centered_instance``: ``image`` is the crop around instance
      ``center_idx`` at the crop size padded to ``max_stride``; its
      ``instances`` ``(B, N, 2)``, ``centroids`` ``(B, 2)`` and
      ``confmaps`` in crop coordinates;
    - ``bottomup``: ``confmaps`` ``(B, H/s, W/s, N)`` (kernel 4 on CUDA) and
      ``pafs`` ``(B, H/ps, W/ps, 2E)``;
    - ``multi_class_topdown``: as ``centered_instance``, and
      ``class_vectors`` ``(B, n_classes)`` of the cropped instance's track;
    - ``multi_class_bottomup``: ``confmaps`` as ``bottomup`` and
      ``class_maps`` ``(B, H/cs, W/cs, n_classes)`` (plain per-instance
      confmaps at the class maps' sigma and stride, then the max over each
      class's instances).
    """
    if ctx.model_type not in _DATASET_BY_TYPE:
        raise _unported("render", ctx.model_type)
    # The edges, copied to each device once: a copy from host memory on
    # every call would wait for the device's queue.
    edge_inds: Dict[torch.device, torch.Tensor] = {}

    @torch.no_grad()
    def fn(batch: Dict[str, torch.Tensor],
           generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        image, instances, eff_scale = preprocess_batch(
            ctx, batch["image"], batch["instances"], generator, train)
        image = apply_pad_to_stride(image, ctx.max_stride)
        h, w = image.shape[1], image.shape[2]
        out: Dict[str, Any] = {"eff_scale": eff_scale, "image": image, "instances": instances}

        if ctx.model_type == "single_instance":
            out["confmaps"] = generate_confmaps(
                instances[:, 0], (h, w), sigma=ctx.sigma, output_stride=ctx.output_stride)

        elif ctx.model_type == "centroid":
            centroids = generate_centroids(instances, ctx.anchor_ind)  # (B, I, 2)
            out["centroids"] = centroids
            out["confmaps"] = generate_multiconfmaps(
                centroids, (h, w), sigma=ctx.sigma, output_stride=ctx.output_stride,
                is_centroids=True)

        elif ctx.model_type in CROP_TYPES:
            rows = torch.arange(image.shape[0], device=image.device)
            sel = batch["center_idx"].long()
            centroids = generate_centroids(instances, ctx.anchor_ind)[rows, sel]  # (B, 2)
            crop_size = int(round(ctx.crop_size * ctx.scale))
            crop_size += (-crop_size) % ctx.max_stride
            out["image"], out["instances"], out["centroids"] = generate_crops(
                image, instances[rows, sel], centroids, crop_size)
            out["confmaps"] = generate_confmaps(
                out["instances"], (crop_size, crop_size), sigma=ctx.sigma,
                output_stride=ctx.output_stride)
            if ctx.model_type == "multi_class_topdown":
                out["class_vectors"] = make_class_vectors(
                    batch["track_ids"][rows, sel], ctx.n_classes)

        elif ctx.model_type == "multi_class_bottomup":
            out["confmaps"] = generate_multiconfmaps(
                instances, (h, w), sigma=ctx.sigma, output_stride=ctx.output_stride)
            out["class_maps"] = generate_class_maps(
                instances, (h, w), batch["track_ids"], ctx.n_classes,
                sigma=ctx.class_maps_sigma, output_stride=ctx.class_maps_output_stride)

        else:  # bottomup
            out["confmaps"] = generate_multiconfmaps(
                instances, (h, w), sigma=ctx.sigma, output_stride=ctx.output_stride)
            if image.device not in edge_inds:
                edge_inds[image.device] = torch.tensor(
                    ctx.edge_inds, dtype=torch.long, device=image.device).reshape(-1, 2)
            out["pafs"] = generate_pafs(
                instances, (h, w), edge_inds[image.device], sigma=ctx.pafs_sigma,
                output_stride=ctx.pafs_output_stride)
        return out

    return fn


# ---------------------------------------------------------------------------
# Host-side datasets
# ---------------------------------------------------------------------------


class BaseDataset:
    """Host-side dataset: index + decode + pad; one item is one frame sample.

    Decoded frames are held in memory (the JAX package's ``cache_mode``
    "memory"; its disk cache, negative frames and user-centroid samples
    are not ported).
    """

    def __init__(self, labels_list: Sequence[Labels], ctx: PipelineContext,
                 user_instances_only: bool = True):
        self.labels_list = list(labels_list)
        self.ctx = ctx
        self.user_instances_only = user_instances_only
        self.samples: List[Dict[str, Any]] = []
        self._build_index()

    def _build_index(self):
        for labels in self.labels_list:
            tindex = {id(t): i for i, t in enumerate(labels.tracks)}
            for lf in labels.labeled_frames:
                video_idx = next(
                    (i for i, v in enumerate(labels.videos) if v is lf.video), 0)
                sample = process_lf(
                    lf,
                    video_idx=video_idx,
                    max_instances=self.ctx.max_instances,
                    user_instances_only=self.user_instances_only,
                    track_index=tindex,
                )
                if sample is None:
                    continue
                sample["sample_weight"] = 1.0
                self._append_samples(sample)

    def _append_samples(self, sample: Dict[str, Any]):
        self.samples.append(sample)

    def __len__(self) -> int:
        return len(self.samples)

    def get_sample(self, idx: int) -> Dict[str, Any]:
        return self.samples[idx]

    def make_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        samples = [self.get_sample(i) for i in indices]
        batch: Dict[str, np.ndarray] = {}
        for key in ("image", "instances", "track_ids", "orig_size"):
            batch[key] = np.stack([s[key] for s in samples])
        for key in ("frame_idx", "video_idx", "num_instances"):
            batch[key] = np.asarray([s[key] for s in samples], dtype=np.int32)
        if "center_idx" in samples[0]:
            batch["center_idx"] = np.asarray([s["center_idx"] for s in samples], dtype=np.int32)
        batch["sample_weight"] = np.asarray(
            [s.get("sample_weight", 1.0) for s in samples], dtype=np.float32
        )
        return batch


class SingleInstanceDataset(BaseDataset):
    """One sample per labeled frame; the first instance supervised."""


class CentroidDataset(BaseDataset):
    """One sample per labeled frame; all centroids supervised."""


class BottomUpDataset(BaseDataset):
    """One sample per labeled frame; confmaps and PAFs."""


class BottomUpMultiClassDataset(BaseDataset):
    """One sample per labeled frame; confmaps and class maps."""


class CenteredInstanceDataset(BaseDataset):
    """One sample per (frame, instance), in frame order: the render crops
    around instance ``center_idx`` of its frame."""

    def _append_samples(self, sample: Dict[str, Any]):
        for k in range(sample["num_instances"]):
            self.samples.append(dict(sample, center_idx=k))


class TopDownCenteredInstanceMultiClassDataset(CenteredInstanceDataset):
    """Centered-instance samples; the render adds class vectors from the
    instances' track ids."""


_DATASET_BY_TYPE = {
    "single_instance": SingleInstanceDataset,
    "centroid": CentroidDataset,
    "centered_instance": CenteredInstanceDataset,
    "bottomup": BottomUpDataset,
    "multi_class_bottomup": BottomUpMultiClassDataset,
    "multi_class_topdown": TopDownCenteredInstanceMultiClassDataset,
}


def make_dataset(model_type: str, labels_list, ctx: PipelineContext,
                 user_instances_only: bool = True) -> BaseDataset:
    if model_type not in _DATASET_BY_TYPE:
        raise _unported("dataset", model_type)
    return _DATASET_BY_TYPE[model_type](labels_list, ctx, user_instances_only)


def build_pipeline_context(cfg, labels: Labels, model_type: str) -> PipelineContext:
    """Static pipeline parameters from a ``TrainingJobConfig`` and labels:
    sizes and strides of the preprocessing and heads, augmentation knobs,
    the skeleton's symmetric node pairs and edges, an identity model's
    class count (its classes, else the labels' tracks) and a crop model's
    crop size (from the labels where the config sets none)."""
    from sleap_nn_tpu_torch.config.utils import get_backbone_config, get_head_config

    pre = cfg.data_config.preprocessing
    backbone = get_backbone_config(cfg)
    head = get_head_config(cfg)
    skel = labels.skeleton

    kw: Dict[str, Any] = dict(
        model_type=model_type,
        n_nodes=len(skel.node_names),
        max_instances=get_max_instances(
            labels, include_user_centroids=(model_type == "centroid")
        ),
        ensure_rgb=pre.ensure_rgb,
        ensure_grayscale=pre.ensure_grayscale,
        max_height=pre.max_height,
        max_width=pre.max_width,
        scale=pre.scale,
        crop_size=pre.crop_size,
        max_stride=backbone.max_stride,
        symmetric_inds=tuple(skel.symmetry_inds),
        use_augmentations=cfg.data_config.use_augmentations_train,
    )
    aug = cfg.data_config.augmentation_config
    if aug is not None:
        kw["intensity"] = _aug_kwargs(aug.intensity) if aug.intensity else None
        kw["geometric"] = _aug_kwargs(aug.geometric) if aug.geometric else None
        if (kw["geometric"] and kw["geometric"].get("flip_p", 0)
                and not kw["symmetric_inds"] and kw["use_augmentations"]):
            print(
                "WARNING: flip augmentation is enabled but the skeleton "
                "defines no symmetries; left/right nodes will NOT be "
                "swapped on flipped frames."
            )

    cm = getattr(head, "confmaps", None)
    if cm is not None:
        kw["sigma"] = cm.sigma
        kw["output_stride"] = cm.output_stride
        anchor = getattr(cm, "anchor_part", None)
        if anchor is not None:
            kw["anchor_ind"] = skel.node_names.index(anchor)
    pafs = getattr(head, "pafs", None)
    if pafs is not None:
        kw["pafs_sigma"] = pafs.sigma
        kw["pafs_output_stride"] = pafs.output_stride
        kw["edge_inds"] = tuple(skel.edge_inds)
    cmaps = getattr(head, "class_maps", None)
    if cmaps is not None:
        kw["class_maps_sigma"] = cmaps.sigma
        kw["class_maps_output_stride"] = cmaps.output_stride
        kw["n_classes"] = len(cmaps.classes or labels.tracks)
    cvec = getattr(head, "class_vectors", None)
    if cvec is not None:
        kw["n_classes"] = len(cvec.classes or labels.tracks)

    if model_type in CROP_TYPES and not kw["crop_size"]:
        rot_max, scale_max = 0.0, 1.0
        if aug is not None and aug.geometric is not None:
            rot_max = max(abs(aug.geometric.rotation_min), abs(aug.geometric.rotation_max))
            scale_max = aug.geometric.scale_max
        padding = compute_augmentation_padding(
            find_instance_crop_size(labels), rot_max, scale_max
        ) if cfg.data_config.use_augmentations_train else 0
        padding += int(pre.crop_padding or 0)  # extra pixels around the instance bbox
        kw["crop_size"] = find_instance_crop_size(
            labels, padding=padding, maximum_stride=backbone.max_stride,
            min_crop_size=pre.min_crop_size)
    return PipelineContext(**kw)


class Loader:
    """Shuffling batch loader with background-thread batch prefetch.

    The JAX package's order and padding: ``np.random.default_rng(seed +
    epoch)`` shuffles; a short last batch is padded with wrap-around
    repeats of the epoch's order and ``batch_mask`` marks the real rows.
    """

    def __init__(self, dataset: BaseDataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, prefetch: int = 2):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        from sleap_nn_tpu_torch.data.prefetch import PrefetchIterator

        if self.prefetch > 0:
            return PrefetchIterator(self._gen(), prefetch=self.prefetch)
        return self._gen()

    def _gen(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        for start in range(0, n, self.batch_size):
            idxs = order[start : start + self.batch_size].tolist()
            n_real = len(idxs)
            idxs = idxs + order[np.arange(self.batch_size - n_real) % n].tolist()
            batch = self.dataset.make_batch(idxs)
            batch["batch_mask"] = np.arange(self.batch_size) < n_real
            yield batch
