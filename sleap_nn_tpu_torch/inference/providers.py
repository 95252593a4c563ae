"""Inference data providers: batched frames with background prefetch.

Port of ``sleap_nn_tpu/inference/providers.py``: ``Batch``,
``VideoProvider`` over a video file by name (opened with
``Video.from_filename``) or any object with ``__len__`` and
``get_frame(idx, fmt)`` returning ``(H, W, C)`` uint8 (an ``io.video.Video``
or an in-memory video), and ``LabelsProvider`` over the labeled frames of a
``Labels``. One thread per provider decodes ahead, ``prefetch`` batches
deep; ``batches(host_step)`` runs a step of the consumer's on each batch on
that thread too. With ``with_centroids``, a ``LabelsProvider`` adds each
frame's ground-truth centroids, their validity and their source scores to
the batch, for the centered-instance-only path
(``GTCentroidTopDownLayer``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from sleap_nn_tpu_torch.data.prefetch import PrefetchIterator
from sleap_nn_tpu_torch.io.video import Video


@dataclasses.dataclass
class Batch:
    """A stack of frames plus provenance indices."""

    frames: np.ndarray  # (B, H, W, C) uint8
    frame_inds: np.ndarray  # (B,)
    video_inds: np.ndarray  # (B,)
    valid: np.ndarray  # (B,) bool, False on padded rows
    gt_centroids: Optional[np.ndarray] = None  # (B, K, 2) original coords, NaN pads
    gt_centroid_valid: Optional[np.ndarray] = None  # (B, K) bool
    gt_centroid_vals: Optional[np.ndarray] = None  # (B, K) source scores (1.0 for user)

    def __len__(self):
        return len(self.frame_inds)


class _Provider:
    """Batches from ``_gen``, decoded ``prefetch`` batches ahead."""

    prefetch: int

    def _gen(self) -> Iterator[Batch]:
        raise NotImplementedError

    def batches(self, host_step: Optional[Callable] = None) -> Iterator:
        """The batches, decoded ahead on a thread of their own; with
        ``host_step``, ``host_step(batch)`` for each, run on that thread."""
        gen = self._gen() if host_step is None else map(host_step, self._gen())
        return PrefetchIterator(gen, self.prefetch, owner="provider")

    def __iter__(self) -> Iterator[Batch]:
        return self.batches()


class VideoProvider(_Provider):
    """Batched frames of a video; a short last batch repeats its last frame."""

    def __init__(
        self,
        video,
        batch_size: int = 4,
        frames: Optional[Sequence[int]] = None,
        prefetch: int = 2,
        video_idx: int = 0,
        out_format: Optional[str] = None,
    ):
        if isinstance(video, str):
            video = Video.from_filename(video)
        self.video = video
        self.batch_size = batch_size
        self.frames = list(frames) if frames is not None else list(range(len(video)))
        self.prefetch = prefetch
        self.video_idx = video_idx
        # 'gray': the video decodes straight to one channel.
        self.out_format = out_format

    def __len__(self):
        return (len(self.frames) + self.batch_size - 1) // self.batch_size

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    def _gen(self) -> Iterator[Batch]:
        bs = self.batch_size
        for start in range(0, len(self.frames), bs):
            idxs = self.frames[start: start + bs]
            imgs = [self.video.get_frame(i, fmt=self.out_format) for i in idxs]
            valid = np.ones(bs, dtype=bool)
            if len(idxs) < bs:
                pad = bs - len(idxs)
                imgs = imgs + [imgs[-1]] * pad
                valid[len(idxs):] = False
                idxs = idxs + [idxs[-1]] * pad
            yield Batch(
                frames=np.stack(imgs),
                frame_inds=np.asarray(idxs, dtype=np.int64),
                video_inds=np.full(bs, self.video_idx, dtype=np.int32),
                valid=valid,
            )



class LabelsProvider(_Provider):
    """Batched frames of the labeled frames of a ``Labels`` (``lf.image``);
    a short last batch repeats its last frame.

    ``user_frames_only``: the frames with user instances only
    (``labels.user_labeled_frames``), whose centroids then come from their
    user instances alone. ``with_centroids``: each batch also carries the
    ground-truth centroids of each frame's first ``max_instances``
    instances, in original image coordinates: the ``anchor_ind`` node where
    it is visible, else the NaN-mean of the visible points. Each slot's
    value is its instance's score (a ``PredictedInstance``), or 1.0 for a
    user instance; empty and padded slots are NaN, invalid and NaN.
    """

    def __init__(self, labels, batch_size: int = 4, prefetch: int = 2,
                 user_frames_only: bool = False, with_centroids: bool = False,
                 max_instances: int = 20, anchor_ind: Optional[int] = None):
        self.labels = labels
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.with_centroids = with_centroids
        self.max_instances = max_instances
        self.anchor_ind = anchor_ind
        self.user_frames_only = user_frames_only
        self.lfs = labels.user_labeled_frames if user_frames_only else labels.labeled_frames

    def __len__(self):
        return (len(self.lfs) + self.batch_size - 1) // self.batch_size

    @property
    def n_frames(self) -> int:
        return len(self.lfs)

    def _video_index(self, video) -> int:
        for i, v in enumerate(self.labels.videos):
            if v is video:
                return i
        return 0

    def _frame_centroids(self, lf):
        """``(centroids (K, 2), valid (K,), values (K,))`` of one frame."""
        k = self.max_instances
        cents = np.full((k, 2), np.nan, np.float32)
        ok = np.zeros(k, bool)
        vals = np.full(k, np.nan, np.float32)
        # A mixed frame of a user-frames-only run gives its user instances
        # alone: its predictions are not ground truth.
        insts = lf.user_instances if self.user_frames_only else lf.instances
        for i, inst in enumerate(insts[:k]):
            pts = np.asarray(inst.numpy(), np.float64)
            c = None
            if self.anchor_ind is not None and 0 <= self.anchor_ind < len(pts):
                a = pts[self.anchor_ind]
                if np.isfinite(a).all():
                    c = a
            if c is None and np.isfinite(pts).any():
                c = np.nanmean(pts, axis=0)
            if c is not None and np.isfinite(c).all():
                cents[i] = c
                ok[i] = True
                score = getattr(inst, "score", None)
                vals[i] = float(score) if score is not None else 1.0
        return cents, ok, vals

    def _gen(self) -> Iterator[Batch]:
        bs = self.batch_size
        for start in range(0, len(self.lfs), bs):
            chunk = self.lfs[start: start + bs]
            imgs = [lf.image for lf in chunk]
            fidx = [lf.frame_idx for lf in chunk]
            vidx = [self._video_index(lf.video) for lf in chunk]
            valid = np.ones(bs, dtype=bool)
            gt = [self._frame_centroids(lf) for lf in chunk] if self.with_centroids else []
            if len(chunk) < bs:
                pad = bs - len(chunk)
                imgs += [imgs[-1]] * pad
                fidx += [fidx[-1]] * pad
                vidx += [vidx[-1]] * pad
                valid[len(chunk):] = False
                if gt:
                    k = self.max_instances
                    gt += [(np.full((k, 2), np.nan, np.float32), np.zeros(k, bool),
                            np.full(k, np.nan, np.float32))] * pad
            gt_c, gt_v, gt_s = (np.stack(a) for a in zip(*gt)) if gt else (None, None, None)
            yield Batch(
                frames=np.stack(imgs),
                frame_inds=np.asarray(fidx, dtype=np.int64),
                video_inds=np.asarray(vidx, dtype=np.int32),
                valid=valid,
                gt_centroids=gt_c,
                gt_centroid_valid=gt_v,
                gt_centroid_vals=gt_s,
            )
