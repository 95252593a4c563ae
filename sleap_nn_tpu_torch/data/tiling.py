"""Tiled training primitives: grid generation, foreground-biased sampling,
extraction.

Port of ``sleap_nn_tpu/data/tiling.py`` (host numpy, a copy of its own):
tile grids snapped to the strides, deterministic per-(frame, tile, epoch)
seeds, foreground-biased origin draws with centre jitter, and fixed-size
zero-padded tile extraction. ``TiledDataset`` (``data/pipeline.py``) and
``TiledLayer`` (``inference/layers.py``) both use them.
"""

from __future__ import annotations

import hashlib
from typing import List, Tuple

import numpy as np


def _axis_tile_origins(
    image_dim: int,
    tile_size: int,
    overlap: int,
    output_stride: int,
    max_stride: int,
    min_overlap_fraction: float,
) -> List[int]:
    """Snapped tile origins along one axis.

    The JAX package's grid (the same origin lists),
    computed here in closed form: the advance between tiles is the tile size
    minus the effective overlap, floored to the coarsest snap unit that still
    lands origins on the output-stride grid; interior origins are then a
    single arithmetic progression and the final flush-right origin is
    appended when it isn't already covered.
    """
    slack = image_dim - tile_size
    if slack <= 0:
        return [0]
    required_overlap = max(overlap, round(min_overlap_fraction * tile_size))
    advance = tile_size - required_overlap
    snap = (
        max_stride
        if (max_stride % output_stride == 0 and advance >= max_stride)
        else output_stride
    )
    advance = max(advance - advance % snap, output_stride)
    # Interior origins: every multiple of `advance` strictly left of the
    # flush-right position, snapped down onto the output-stride grid.
    n_interior = -(-slack // advance)  # ceil(slack / advance), slack > 0
    grid = (np.arange(n_interior, dtype=np.int64) * advance) // output_stride
    origins = (grid * output_stride).tolist()
    flush_right = (slack // output_stride) * output_stride
    if origins[-1] != flush_right:
        origins.append(flush_right)
    return [int(v) for v in origins]


def generate_tile_grid(
    image_hw: Tuple[int, int],
    tile_size: int,
    overlap: int,
    output_stride: int,
    max_stride: int = 1,
    min_overlap_fraction: float = 0.25,
) -> List[Tuple[int, int]]:
    """(y0, x0) tile origins covering the image, row-major."""
    ys = _axis_tile_origins(
        image_hw[0], tile_size, overlap, output_stride, max_stride, min_overlap_fraction
    )
    xs = _axis_tile_origins(
        image_hw[1], tile_size, overlap, output_stride, max_stride, min_overlap_fraction
    )
    return [(y, x) for y in ys for x in xs]


def tile_sample_seed(base_seed: int, frame_key: str, sample_k: int, epoch: int) -> int:
    """Deterministic per-(frame, tile-slot, epoch) seed."""
    payload = f"{base_seed}|{frame_key}|{sample_k}|{epoch}".encode()
    return int.from_bytes(hashlib.sha256(payload).digest()[:8], "little")


def frame_foreground_centers(
    instances: np.ndarray, min_visible_keypoints: int = 1
) -> np.ndarray:
    """Candidate tile centers = instance centroids with enough visible points."""
    centers = []
    for inst in instances:
        visible = ~np.isnan(inst[:, 0])
        if visible.sum() >= max(min_visible_keypoints, 1):
            centers.append(np.nanmean(inst, axis=0))
    return np.asarray(centers).reshape(-1, 2)


def draw_tile_origin(
    centers: np.ndarray,
    frame_hw: Tuple[int, int],
    tile_size: int,
    sample_k: int,
    samples_per_frame: int,
    tile_fg_fraction: float,
    center_jitter: float,
    rng: np.random.Generator,
    pos_ratio: float = 1.0,
) -> Tuple[int, int]:
    """Draw one (optionally fg-biased) unclamped tile origin."""
    H, W = frame_hw
    M = centers.shape[0]
    force_fg = sample_k >= round(samples_per_frame * (1.0 - tile_fg_fraction))
    if M == 0 or pos_ratio == 0.0 or not force_fg:
        x0 = int(rng.integers(0, max(1, W - tile_size + 1)))
        y0 = int(rng.integers(0, max(1, H - tile_size + 1)))
        return y0, x0
    c = centers[rng.integers(M)]
    jx = float(rng.uniform(-1, 1)) * center_jitter * (tile_size / 2.0)
    jy = float(rng.uniform(-1, 1)) * center_jitter * (tile_size / 2.0)
    x0 = int(round(float(c[0]) - tile_size / 2.0 + jx))
    y0 = int(round(float(c[1]) - tile_size / 2.0 + jy))
    return y0, x0


def extract_tile(
    image: np.ndarray,
    instances: np.ndarray,
    tile_origin: Tuple[int, int],
    tile_size: int,
    min_visible_keypoints: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-size zero-padded tile crop + tile-local instances.

    Args:
        image: ``(H, W, C)``; instances ``(I, N, 2)`` (x, y), NaN padded.
        tile_origin: ``(y0, x0)`` — may be partially outside the frame.

    Returns:
        ``(tile (tile, tile, C), tile_instances (I, N, 2))``. Instance points
        outside the tile are NaN; instances with fewer than
        ``min_visible_keypoints`` visible points are fully NaN.
    """
    h, w, c = image.shape
    y0, x0 = tile_origin
    tile = np.zeros((tile_size, tile_size, c), dtype=image.dtype)
    ys0, xs0 = max(y0, 0), max(x0, 0)
    ys1, xs1 = min(y0 + tile_size, h), min(x0 + tile_size, w)
    if ys1 > ys0 and xs1 > xs0:
        tile[ys0 - y0 : ys1 - y0, xs0 - x0 : xs1 - x0] = image[ys0:ys1, xs0:xs1]

    pts = instances.copy().astype(np.float32)
    pts[..., 0] -= x0
    pts[..., 1] -= y0
    oob = (
        (pts[..., 0] < 0)
        | (pts[..., 0] >= tile_size)
        | (pts[..., 1] < 0)
        | (pts[..., 1] >= tile_size)
    )
    pts[oob] = np.nan
    visible = (~np.isnan(pts[..., 0])).sum(axis=-1)
    pts[visible < min_visible_keypoints] = np.nan
    return tile, pts


class FrameGroupedTileSampler:
    """Epoch-seeded sampler keeping each frame's tiles together as a block.

    As the JAX package's sampler (a frame-block sampler
    with ``set_epoch``); per-process sharding replaces DistributedSampler.
    """

    def __init__(
        self,
        n_frames: int,
        samples_per_frame: int,
        shuffle: bool = True,
        seed: int = 0,
        num_replicas: int = 1,
        rank: int = 0,
    ):
        self.n_frames = n_frames
        self.samples_per_frame = samples_per_frame
        self.shuffle = shuffle
        self.seed = seed
        self.num_replicas = num_replicas
        self.rank = rank
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def __len__(self) -> int:
        frames_per_rank = (self.n_frames + self.num_replicas - 1) // self.num_replicas
        return frames_per_rank * self.samples_per_frame

    def __iter__(self):
        order = np.arange(self.n_frames)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(order)
        # Strided per-rank assignment of whole frames.
        mine = order[self.rank :: self.num_replicas]
        for f in mine:
            for k in range(self.samples_per_frame):
                yield int(f), int(k)
