"""Training data pipeline: host datasets, the loader and the device render.

Port of ``sleap_nn_tpu/data/pipeline.py`` for single-instance, centroid,
centered-instance, bottom-up, identity (multi-class bottom-up and
top-down) and segmentation (bottom-up, semantic and centered-instance)
models. The host side indexes labeled
frames, decodes and NaN-pads them (numpy); the render function built by
:func:`make_render_fn` runs on the training device under
``torch.no_grad()``: normalize, channels, sizematch, scale, augment, pad to
stride, then the model type's targets: confidence maps (the centroid and
bottom-up maps through kernel 4 on CUDA), instance crops, part affinity
fields, class maps and class vectors, and for segmentation the masks drawn
from the keypoints, the foreground mask, the centre heatmap and offsets.

Frame-level datasets take negative frames (labeled frames without an
instance: all-NaN keypoints, so empty targets, and ``sample_weight`` =
``negative_loss_weight``) and, for centroid models, user-annotated
centroids. Decoded frames stay in memory, or with ``cache_mode="disk"``
go to ``.npy`` files read back per sample. ``TiledDataset`` wraps a
frame-level dataset and draws fixed-size tiles of each frame per epoch
(with a halo that the train render crops away after a geometric
augmentation).
"""

from __future__ import annotations

import dataclasses
import math
import os
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
from sleap_nn_tpu_torch.data.segmentation_maps import (
    generate_center_heatmap,
    generate_center_offsets,
    generate_foreground_mask,
    render_masks_from_instances,
)
from sleap_nn_tpu_torch.data.tiling import (
    draw_tile_origin,
    extract_tile,
    frame_foreground_centers,
    generate_tile_grid,
    tile_sample_seed,
)
from sleap_nn_tpu_torch.io.model import Labels, is_negative_frame
from sleap_nn_tpu_torch.ops.confmaps import generate_confmaps, generate_multiconfmaps
from sleap_nn_tpu_torch.ops.edge_maps import generate_pafs
from sleap_nn_tpu_torch.parallel.mesh import shard_rows

# Model types trained on crops around one instance.
CROP_TYPES = ("centered_instance", "multi_class_topdown", "centered_instance_segmentation")


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
    # segmentation
    seg_output_stride: int = 2
    seg_maxpool: bool = False
    center_sigma: float = 4.0
    center_output_stride: int = 2
    offsets_output_stride: int = 2
    mask_radius: float = 12.0
    # augmentation
    use_augmentations: bool = False
    intensity: Optional[dict] = None
    geometric: Optional[dict] = None
    symmetric_inds: Tuple[Tuple[int, int], ...] = ()
    # Tiled training with geometric augmentation: train tiles come with a
    # halo (side ceil(tile * sqrt(2))), and after the augmentation the train
    # render centre-crops them back to this tile size, so that a rotation
    # never pulls zero padding into the tile.
    halo_crop_to: Optional[int] = None


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
    rows: Optional[torch.Tensor] = None,
    global_batch: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor, float]:
    """normalize -> channels -> sizematch -> scale -> augment -> the halo's
    centre crop (not yet padded to stride). Returns ``(image, instances,
    eff_scale)``. The batch may be the ``rows`` of a ``global_batch``,
    whose augmentation draws it then keeps (``data.augmentation``)."""
    image = normalize_image(image)
    image = apply_channel_config(image, ctx.ensure_rgb, ctx.ensure_grayscale)
    image, eff_scale = apply_sizematcher(image, ctx.max_height, ctx.max_width)
    instances = instances * eff_scale
    image, instances = apply_resizer(image, instances, ctx.scale)

    if train and ctx.use_augmentations and generator is not None:
        if ctx.intensity:
            image = apply_intensity_augmentation(generator, image, rows, global_batch,
                                                 **ctx.intensity)
        if ctx.geometric:
            image, instances = apply_geometric_augmentation(
                generator, image, instances, symmetric_inds=ctx.symmetric_inds or None,
                rows=rows, global_batch=global_batch, **ctx.geometric)
    if train and ctx.halo_crop_to is not None:
        target = int(round(ctx.halo_crop_to * ctx.scale))
        h, w = image.shape[-3], image.shape[-2]
        if h > target or w > target:
            off_h, off_w = (h - target) // 2, (w - target) // 2
            image = image[..., off_h:off_h + target, off_w:off_w + target, :]
            instances = instances - torch.tensor([off_w, off_h], dtype=instances.dtype,
                                                 device=instances.device)
    return image, instances, eff_scale


def make_render_fn(ctx: PipelineContext, train: bool) -> Callable:
    """Build the device-side ``batch -> {inputs, targets}`` function.

    The returned ``fn(batch, generator=None, rows=None, global_batch=None)``
    (``rows`` as :func:`preprocess_batch`) takes a dict of tensors on the
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
      class's instances);
    - ``bottomup_segmentation`` and ``semantic_segmentation``: instance
      masks drawn from the (augmented) keypoints as capsules of
      ``mask_radius`` around the edges, and their ``segmentation``
      ``(B, H/s, W/s, 1)``; bottom-up adds ``center_heatmap``,
      ``center_offsets`` and ``offsets_mask``;
    - ``centered_instance_segmentation``: the crop of ``centered_instance``
      and the ``segmentation`` of its instance's mask.
    """
    if ctx.model_type not in _DATASET_BY_TYPE:
        raise NotImplementedError(f"Render fn for model type {ctx.model_type}")
    # The edges, copied to each device once: a copy from host memory on
    # every call would wait for the device's queue.
    edge_inds: Dict[torch.device, torch.Tensor] = {}

    def edges_on(device) -> torch.Tensor:
        if device not in edge_inds:
            edge_inds[device] = torch.tensor(
                ctx.edge_inds, dtype=torch.long, device=device).reshape(-1, 2)
        return edge_inds[device]

    @torch.no_grad()
    def fn(batch: Dict[str, torch.Tensor], generator: Optional[torch.Generator] = None,
           rows: Optional[torch.Tensor] = None,
           global_batch: Optional[int] = None) -> Dict[str, Any]:
        image, instances, eff_scale = preprocess_batch(
            ctx, batch["image"], batch["instances"], generator, train, rows, global_batch)
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

        elif ctx.model_type in ("bottomup_segmentation", "semantic_segmentation"):
            masks = render_masks_from_instances(
                instances, (h, w), edges_on(image.device), ctx.mask_radius)  # (B, I, H, W)
            valid = (~torch.isnan(instances[..., 0])).any(dim=-1)  # (B, I)
            out["segmentation"] = generate_foreground_mask(
                masks, valid, ctx.seg_output_stride, ctx.seg_maxpool)
            if ctx.model_type == "bottomup_segmentation":
                out["center_heatmap"] = generate_center_heatmap(
                    masks, valid, ctx.center_output_stride, ctx.center_sigma)
                out["center_offsets"], out["offsets_mask"] = generate_center_offsets(
                    masks, valid, ctx.offsets_output_stride)

        elif ctx.model_type == "centered_instance_segmentation":
            rows = torch.arange(image.shape[0], device=image.device)
            sel = batch["center_idx"].long()
            centroids = generate_centroids(instances, ctx.anchor_ind)[rows, sel]  # (B, 2)
            crop_size = int(round(ctx.crop_size * ctx.scale))
            crop_size += (-crop_size) % ctx.max_stride
            out["image"], inst, _ = generate_crops(
                image, instances[rows, sel], centroids, crop_size)
            out["instances"] = inst
            masks = render_masks_from_instances(
                inst[:, None], (crop_size, crop_size), edges_on(image.device),
                ctx.mask_radius)  # (B, 1, crop, crop)
            valid = (~torch.isnan(inst[..., 0])).any(dim=-1, keepdim=True)
            out["segmentation"] = generate_foreground_mask(
                masks, valid, ctx.seg_output_stride, ctx.seg_maxpool)

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
            out["pafs"] = generate_pafs(
                instances, (h, w), edges_on(image.device), sigma=ctx.pafs_sigma,
                output_stride=ctx.pafs_output_stride)
        return out

    return fn


# ---------------------------------------------------------------------------
# Host-side datasets
# ---------------------------------------------------------------------------


class BaseDataset:
    """Host-side dataset: index + decode + pad; one item is one frame sample.

    Decoded frames are held in memory (``cache_mode="memory"``), or with
    ``cache_mode="disk"`` saved as ``sample_{i}.npy`` under ``cache_dir``
    (a new temporary directory where None) and loaded back by
    ``get_sample``; ``use_existing_imgs`` keeps a file that is already
    there, and ``cache_workers`` above 1 writes them from a thread pool.
    ``use_negative_frames`` adds
    each labeled frame without an instance as a negative: all-NaN
    keypoints (empty targets) and ``sample_weight`` =
    ``negative_loss_weight``. ``centroid_from_user`` (centroid models)
    trains a frame that carries user-annotated centroids on those points,
    as instances with every node at the centroid.
    """

    # A crop-level dataset (one sample per instance) has no frame-level
    # sample to attach a negative to, and skips negatives.
    supports_negative_frames = True

    def __init__(self, labels_list: Sequence[Labels], ctx: PipelineContext,
                 user_instances_only: bool = True, use_negative_frames: bool = False,
                 negative_loss_weight: float = 1.0, centroid_from_user: bool = False,
                 cache_mode: str = "memory", cache_dir=None, use_existing_imgs: bool = False,
                 cache_workers: int = 0):
        self.labels_list = list(labels_list)
        self.ctx = ctx
        self.user_instances_only = user_instances_only
        self.use_negative_frames = use_negative_frames
        self.negative_loss_weight = negative_loss_weight
        self.centroid_from_user = centroid_from_user
        self.cache_mode = cache_mode
        self.cache_dir = cache_dir
        self.samples: List[Dict[str, Any]] = []
        self._build_index()
        if cache_mode == "disk":
            self._spill_to_disk(use_existing=use_existing_imgs, workers=cache_workers)

    def _build_index(self):
        for labels in self.labels_list:
            tindex = {id(t): i for i, t in enumerate(labels.tracks)}
            for lf in labels.labeled_frames:
                video_idx = next(
                    (i for i, v in enumerate(labels.videos) if v is lf.video), 0)
                if self.centroid_from_user and lf.user_centroids:
                    sample = self._make_sample(lf, video_idx, lf.user_centroids)
                    if sample is not None:
                        self.samples.append(sample)
                    continue
                sample = process_lf(
                    lf,
                    video_idx=video_idx,
                    max_instances=self.ctx.max_instances,
                    user_instances_only=self.user_instances_only,
                    track_index=tindex,
                )
                if sample is None:
                    # Only a truly empty labeled frame is a negative; a frame
                    # whose instances are all empty or out of bounds is skipped.
                    if (self.use_negative_frames and self.supports_negative_frames
                            and is_negative_frame(lf)):
                        neg = self._make_sample(lf, video_idx, [], self.negative_loss_weight)
                        if neg is not None:
                            self.samples.append(neg)
                    continue
                sample["sample_weight"] = 1.0
                self._append_samples(sample)

    def _make_sample(self, lf, video_idx: int, centroids, weight: float = 1.0):
        """A frame sample whose instances sit at ``centroids`` (every node at
        the centroid, so the centroid render gives back the annotated
        point); with no centroid, a negative with all-NaN keypoints. None
        where the frame does not decode."""
        try:
            img = lf.image
        except Exception:
            return None
        if img.ndim == 2:
            img = img[..., None]
        cents = centroids[: self.ctx.max_instances]
        pts = np.full((self.ctx.max_instances, self.ctx.n_nodes, 2), np.nan, np.float32)
        for i, c in enumerate(cents):
            pts[i, :, :] = np.asarray(c.point, np.float32)
        return {
            "image": np.ascontiguousarray(img),
            "instances": pts,
            "num_instances": len(cents),
            "frame_idx": int(lf.frame_idx),
            "video_idx": int(video_idx),
            "orig_size": np.array(img.shape[:2], np.float32),
            "track_ids": np.full((self.ctx.max_instances,), -1, np.int32),
            "sample_weight": float(weight),
        }

    def _spill_to_disk(self, use_existing: bool = False, workers: int = 0):
        """Move each sample's decoded frame to ``sample_{i}.npy``; the
        sample keeps its path."""
        import tempfile
        from pathlib import Path

        cache_dir = Path(self.cache_dir or tempfile.mkdtemp(prefix="sleap_torch_cache_"))
        cache_dir.mkdir(parents=True, exist_ok=True)
        self.cache_dir = cache_dir

        def spill_one(i_s):
            i, s = i_s
            path = cache_dir / f"sample_{i}.npy"
            if not (use_existing and path.exists()):
                # Written aside and renamed into place: the ranks of a
                # data-parallel run fill one cache at once.
                tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
                with open(tmp, "wb") as fp:
                    np.save(fp, s["image"])
                os.replace(tmp, path)
            s["image_path"] = str(path)
            del s["image"]

        if workers and workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(spill_one, enumerate(self.samples)))
        else:
            for item in enumerate(self.samples):
                spill_one(item)

    def _append_samples(self, sample: Dict[str, Any]):
        self.samples.append(sample)

    def __len__(self) -> int:
        return len(self.samples)

    def get_sample(self, idx: int) -> Dict[str, Any]:
        s = self.samples[idx]
        if "image" not in s and "image_path" in s:
            s = dict(s, image=np.load(s["image_path"]))
        return s

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
    around instance ``center_idx`` of its frame. No negatives."""

    supports_negative_frames = False

    def _append_samples(self, sample: Dict[str, Any]):
        for k in range(sample["num_instances"]):
            self.samples.append(dict(sample, center_idx=k))


class TopDownCenteredInstanceMultiClassDataset(CenteredInstanceDataset):
    """Centered-instance samples; the render adds class vectors from the
    instances' track ids."""


class BottomUpSegmentationDataset(BaseDataset):
    """One sample per labeled frame; foreground, centre heatmap and offsets."""


class SemanticSegmentationDataset(BaseDataset):
    """One sample per labeled frame; the foreground mask only."""


class CenteredInstanceSegmentationDataset(CenteredInstanceDataset):
    """One sample per (frame, instance); the crop's foreground mask."""


class TiledDataset:
    """Epoch-seeded tile sampler over a frame-level dataset (the JAX
    package's one wrapper for every frame-level type, the two whole-frame
    segmentation datasets included).

    Each epoch draws ``samples_per_frame`` fixed-size tiles of each frame
    (the grid count of the first frame where unset), deterministic per
    ``(frame, tile, epoch)`` through ``tile_sample_seed``: with
    ``sampling="foreground"`` origins biased to the instances' centres with
    jitter, with ``"grid"`` the tiles of the full-coverage grid (output
    stride 1). Instances move into tile coordinates; the visible ones come
    first, with ``track_ids`` kept aligned. ``use_halo``: tiles are cut
    ``ceil(tile * sqrt(2))`` wide around the same centre, for the train
    render to crop back after a rotation. ``full_frame_pass`` adds one slot
    per frame holding the whole frame resized (cv2 ``INTER_AREA``) onto a
    tile (or halo) canvas. ``Loader.set_epoch`` re-draws the tiles.
    """

    def __init__(self, inner: BaseDataset, tiling, base_seed: int = 0, use_halo: bool = False):
        if not tiling.tile_size:
            raise ValueError("tiling.enabled requires tiling.tile_size.")
        self.inner = inner
        self.cfg = tiling
        self.base_seed = base_seed
        self.epoch = 0
        self.use_halo = bool(use_halo)
        self.halo_size = int(math.ceil(tiling.tile_size * math.sqrt(2.0)))
        self.sampling = getattr(tiling, "sampling", "foreground") or "foreground"
        self._grid = generate_tile_grid(
            inner.get_sample(0)["image"].shape[:2], tiling.tile_size,
            overlap=tiling.overlap or 0, output_stride=1,
            min_overlap_fraction=tiling.min_overlap_fraction)
        if self.sampling != "grid" and tiling.samples_per_frame:
            self.samples_per_frame = int(tiling.samples_per_frame)
        else:
            self.samples_per_frame = max(1, len(self._grid))
        self.full_frame_pass = bool(getattr(tiling, "full_frame_pass", False))
        if self.full_frame_pass:
            self.samples_per_frame += 1

    def set_epoch(self, epoch: int):
        self.epoch = int(epoch)

    def __len__(self) -> int:
        return len(self.inner) * self.samples_per_frame

    @property
    def ctx(self):
        return self.inner.ctx

    @property
    def samples(self):
        return self.inner.samples

    @staticmethod
    def _with_tile(s: Dict[str, Any], image: np.ndarray, pts: np.ndarray, side: int):
        """``s`` on a tile: its instances with the visible ones first."""
        vis = ~np.isnan(pts[..., 0]).all(axis=-1)
        order = np.concatenate([np.nonzero(vis)[0], np.nonzero(~vis)[0]])
        out = dict(s, image=image, instances=pts[order],
                   orig_size=np.array([side, side], np.float32), num_instances=int(vis.sum()))
        if "track_ids" in s:
            out["track_ids"] = np.asarray(s["track_ids"])[order]
        return out

    def get_sample(self, idx: int) -> Dict[str, Any]:
        frame_i, k = divmod(int(idx), self.samples_per_frame)
        s = self.inner.get_sample(frame_i)
        if self.full_frame_pass and k == self.samples_per_frame - 1:
            return self._full_frame_sample(s)
        cfg = self.cfg
        rng = np.random.default_rng(tile_sample_seed(
            self.base_seed, f"{s['video_idx']}:{s['frame_idx']}", k, self.epoch))
        if self.sampling == "grid":
            origin = tuple(self._grid[k % max(1, len(self._grid))])
        else:
            origin = draw_tile_origin(
                frame_foreground_centers(s["instances"]), s["image"].shape[:2], cfg.tile_size,
                sample_k=k, samples_per_frame=self.samples_per_frame,
                tile_fg_fraction=cfg.tile_fg_fraction, center_jitter=cfg.center_jitter,
                rng=rng)
        side = cfg.tile_size
        if self.use_halo:
            # The halo centred on the tile's centre.
            margin = (self.halo_size - cfg.tile_size) // 2
            origin, side = (origin[0] - margin, origin[1] - margin), self.halo_size
        tile, pts = extract_tile(s["image"], s["instances"], origin, side,
                                 min_visible_keypoints=cfg.min_visible_keypoints)
        return self._with_tile(s, tile, pts, cfg.tile_size)

    def _full_frame_sample(self, s: Dict[str, Any]) -> Dict[str, Any]:
        """The frame resized to fit a tile, centred on a tile (or halo)
        canvas: the ``full_frame_pass`` slot."""
        import cv2

        ts = int(self.cfg.tile_size)
        img = s["image"]
        h, w = img.shape[:2]
        scale = min(ts / h, ts / w)
        nh, nw = max(1, int(round(h * scale))), max(1, int(round(w * scale)))
        resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_AREA)
        if resized.ndim == 2:
            resized = resized[..., None]
        canvas_size = self.halo_size if self.use_halo else ts
        off = ((canvas_size - nh) // 2, (canvas_size - nw) // 2)
        canvas = np.zeros((canvas_size, canvas_size, img.shape[2]), img.dtype)
        canvas[off[0]:off[0] + nh, off[1]:off[1] + nw] = resized
        pts = np.asarray(s["instances"], np.float32).copy()
        pts *= scale
        pts[..., 0] += off[1]
        pts[..., 1] += off[0]
        return self._with_tile(s, canvas, pts, ts)

    def make_batch(self, indices: Sequence[int]) -> Dict[str, np.ndarray]:
        return BaseDataset.make_batch(self, indices)


_DATASET_BY_TYPE = {
    "single_instance": SingleInstanceDataset,
    "centroid": CentroidDataset,
    "centered_instance": CenteredInstanceDataset,
    "bottomup": BottomUpDataset,
    "multi_class_bottomup": BottomUpMultiClassDataset,
    "multi_class_topdown": TopDownCenteredInstanceMultiClassDataset,
    "bottomup_segmentation": BottomUpSegmentationDataset,
    "semantic_segmentation": SemanticSegmentationDataset,
    "centered_instance_segmentation": CenteredInstanceSegmentationDataset,
}


def make_dataset(model_type: str, labels_list, ctx: PipelineContext, **kwargs) -> BaseDataset:
    """The model type's dataset; ``kwargs`` go to :class:`BaseDataset`."""
    if model_type not in _DATASET_BY_TYPE:
        raise NotImplementedError(f"No dataset for model type: {model_type}")
    return _DATASET_BY_TYPE[model_type](labels_list, ctx, **kwargs)


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
    seg = getattr(head, "segmentation", None)
    if seg is not None:
        kw["seg_output_stride"] = seg.output_stride
        kw["seg_maxpool"] = bool(getattr(seg, "target_maxpool", False))
        kw["edge_inds"] = tuple(skel.edge_inds)
        anchor = getattr(seg, "anchor_part", None)
        if anchor:
            kw["anchor_ind"] = skel.node_names.index(anchor)
    center = getattr(head, "center", None)
    if center is not None:
        kw["center_sigma"] = center.sigma
        kw["center_output_stride"] = center.output_stride
    offsets = getattr(head, "offsets", None)
    if offsets is not None:
        kw["offsets_output_stride"] = offsets.output_stride

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

    Under data-parallel training (``num_ranks`` above 1) every rank walks
    the same order and yields only its contiguous ``batch_size /
    num_ranks`` rows of each global batch of ``batch_size`` (the rows that
    JAX's ``P("data")`` sharding gives its device), with its slice of
    ``batch_mask`` and ``n_real``, the real rows of the whole global batch.
    ``lead_row`` puts the global row before the rank's first (cyclically)
    ahead of them, for mixup, which blends each row with the one before
    it. ``rows`` holds the global rows a batch holds, in its order.
    """

    def __init__(self, dataset: BaseDataset, batch_size: int, shuffle: bool = False,
                 seed: int = 0, prefetch: int = 2, rank: int = 0, num_ranks: int = 1,
                 lead_row: bool = False):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.prefetch = prefetch
        self.epoch = 0
        self.num_ranks = num_ranks
        own = shard_rows(batch_size, rank, num_ranks)
        lead = [(own.start - 1) % batch_size] if lead_row else []
        self.rows = np.asarray(lead + list(range(own.start, own.stop)))

    def set_epoch(self, epoch: int):
        """The epoch of the shuffle, and of a tiled dataset's draws."""
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def __len__(self) -> int:
        return (len(self.dataset) + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        from sleap_nn_tpu_torch.data.prefetch import PrefetchIterator

        if self.prefetch > 0:
            return PrefetchIterator(self._gen(), prefetch=self.prefetch, owner="loader")
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
            batch = self.dataset.make_batch([idxs[i] for i in self.rows])
            batch["batch_mask"] = (np.arange(self.batch_size) < n_real)[self.rows]
            if self.num_ranks > 1:
                batch["n_real"] = n_real
            yield batch
