"""Inference data providers: batched frames with background prefetch.

Port of ``sleap_nn_tpu/inference/providers.py``: ``Batch``,
``VideoProvider`` over a video file by name (opened with
``Video.from_filename``) or any object with ``__len__`` and
``get_frame(idx, fmt)`` returning ``(H, W, C)`` uint8 (an ``io.video.Video``
or an in-memory video), and ``LabelsProvider`` over the labeled frames of a
``Labels``. One thread per provider decodes ahead, ``prefetch`` batches
deep; ``batches(host_step)`` runs a step of the consumer's on each batch on
that thread too. The ground-truth centroids of the centered-instance-only
path are not ported (ROADMAP.md section 1, item 10).
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
        return PrefetchIterator(gen, self.prefetch)

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
    a short last batch repeats its last frame."""

    def __init__(self, labels, batch_size: int = 4, prefetch: int = 2):
        self.labels = labels
        self.batch_size = batch_size
        self.prefetch = prefetch
        self.lfs = labels.labeled_frames

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

    def _gen(self) -> Iterator[Batch]:
        bs = self.batch_size
        for start in range(0, len(self.lfs), bs):
            chunk = self.lfs[start: start + bs]
            imgs = [lf.image for lf in chunk]
            fidx = [lf.frame_idx for lf in chunk]
            vidx = [self._video_index(lf.video) for lf in chunk]
            valid = np.ones(bs, dtype=bool)
            if len(chunk) < bs:
                pad = bs - len(chunk)
                imgs += [imgs[-1]] * pad
                fidx += [fidx[-1]] * pad
                vidx += [vidx[-1]] * pad
                valid[len(chunk):] = False
            yield Batch(
                frames=np.stack(imgs),
                frame_inds=np.asarray(fidx, dtype=np.int64),
                video_inds=np.asarray(vidx, dtype=np.int32),
                valid=valid,
            )

