"""Predictor: providers -> layer -> per-batch numpy outputs.

Port of ``Predictor.predict`` of ``sleap_nn_tpu/inference/predictor.py``
for a layer built by the caller (the top-down or bottom-up layer of this
package), with ``make_labels=False``. Building from model directories
(``from_model_paths``) and ``.slp`` output (``to_labels``) are not ported
yet.

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
import queue
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from sleap_nn_tpu_torch.inference.backends import resolve_device
from sleap_nn_tpu_torch.inference.layers import to_host
from sleap_nn_tpu_torch.inference.providers import VideoProvider
from sleap_nn_tpu_torch.inference.streaming import PafGroupingPool


def rgb_to_gray_uint8(frames: np.ndarray) -> np.ndarray:
    """ITU-601 luma on a uint8 batch, (B, H, W, 3) -> (B, H, W, 1).

    Bit-identical to ``cv2.cvtColor(..., COLOR_RGB2GRAY)``, which the JAX
    package calls: 15-bit fixed-point weights, rounded half up.
    """
    f = frames.astype(np.uint32)
    luma = (f[..., 0] * 9798 + f[..., 1] * 19235 + f[..., 2] * 3735 + (1 << 14)) >> 15
    return luma.astype(np.uint8)[..., None]


class Predictor:
    """Runs batched inference of one layer over a frame source.

    ``paf_workers``: for a bottom-up layer, the number of worker processes
    that group PAF scores into instances (0 groups on the fetch thread).
    """

    def __init__(self, layer, model_type: str, skeleton=None, models: Sequence = (),
                 batch_size: int = 4, device="cuda", paf_workers: int = 0):
        self.device = resolve_device(device)
        if layer.device != self.device:
            raise ValueError(f"layer runs on {layer.device}, predictor on {self.device}")
        self.layer = layer
        self.model_type = model_type
        self.skeleton = skeleton
        self.models = list(models)
        self.batch_size = batch_size
        self.paf_workers = paf_workers
        # A grayscale model gets its frames converted on the host, before
        # the copy to the device (3x fewer bytes).
        pre = getattr(getattr(layer, "centroid_layer", layer), "pre", None)
        self._host_grayscale = bool(pre and pre.ensure_grayscale)
        self.last_stats: Dict[str, float] = {}

    def _make_provider(self, data, frames=None):
        if isinstance(data, (str, Path)):
            raise NotImplementedError(
                "reading a video or .slp file needs the io slice, not ported yet; "
                "pass an object with __len__ and get_frame(idx, fmt), or a provider")
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
                make_labels: bool = True, provider=None) -> List[Dict[str, Any]]:
        """Run inference over a frame source; returns the per-batch output dicts.

        Each dict holds the layer's outputs as numpy plus ``frame_inds``,
        ``video_inds`` and ``valid`` (False on the padded rows of a short
        last batch).
        """
        if make_labels:
            raise NotImplementedError(
                "Labels output (Predictor.to_labels, .slp writing) is not ported yet; "
                "pass make_labels=False")
        provider = provider or self._make_provider(data, frames)
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
        return results
