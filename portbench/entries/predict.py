"""Top-down predict cells: one ``Predictor.predict`` call over frames read
until a deadline.

Set-up builds the configuration's layer (``core/build.py``) on weights
drawn from the seed, draws a pool of uint8 frames, and runs a short
predict of the cell's own shapes (``warmup_batches``), which builds every
kernel. The window is one ``Predictor.predict(provider=...,
make_labels=False)``: the provider reads the pool's frames in turn
through a video's ``get_frame`` on its own thread and stops yielding
batches at the deadline; the predictor drains what it holds and returns.

- ``predict_fps``: frames completed over the window, from its start to the
  return of ``predict``;
- ``predict_latency_p95_ms``: the 95th percentile, over every frame
  completed, of the time from the provider's read of the frame to the
  ``progress_callback`` that reported its batch done.

After the window (and after the device's peak memory is read) the
program's state is freed and a sample of the completed frames, drawn from
the seed, is judged against the plain reference (``reference/``).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, Optional

import numpy as np

from portbench.core import build
from portbench.core.run import Outcome, RunContext


class PoolVideo:
    """A video whose frame ``i`` is the pool's frame ``i mod len(pool)``; it
    notes when each frame was read."""

    def __init__(self, pool: np.ndarray):
        self.pool = pool
        self.shape = (2**31,) + pool.shape[1:]
        self.read_at: Dict[int, float] = {}

    def __len__(self):
        return self.shape[0]

    def get_frame(self, idx, fmt=None):
        self.read_at[idx] = time.perf_counter()
        return self.pool[idx % len(self.pool)]


def provider(video: PoolVideo, batch_size: int, deadline: Optional[float] = None,
             n_batches: Optional[int] = None, note: Optional[Callable] = None):
    """Batches of consecutive frames of ``video``, until ``deadline`` (or for
    ``n_batches``), read on the provider's own thread."""
    from sleap_nn_tpu_torch.inference.providers import Batch, VideoProvider

    class DeadlineProvider(VideoProvider):
        def __bool__(self):  # its length is not known ahead
            return True

        def _gen(self):
            i = 0
            while (time.perf_counter() < deadline) if n_batches is None else (i < n_batches * batch_size):
                idxs = list(range(i, i + batch_size))
                t_ns = time.time_ns()
                frames = np.stack([self.video.get_frame(j) for j in idxs])
                if note is not None:
                    note("read_frames", t_ns, time.time_ns())
                yield Batch(frames=frames, frame_inds=np.asarray(idxs, dtype=np.int64),
                            video_inds=np.zeros(batch_size, dtype=np.int32),
                            valid=np.ones(batch_size, dtype=bool))
                i += batch_size

    return DeadlineProvider(video, batch_size=batch_size, frames=[])


def program_layer(ctx: RunContext):
    """``(layer, reference weights)`` of the configuration, built on ``ctx.device``."""
    cfg, bf16 = ctx.config, ctx.traffic["precision"] == "bf16"
    centroid, instance = build.topdown_models(cfg, ctx.seed, ctx.device)
    layer = build.topdown_layer(cfg, centroid, instance, ctx.device, bf16)
    return layer, {"centroid": build.weights(centroid), "instance": build.weights(instance)}


def forward_flops(ctx: RunContext, states: Dict) -> float:
    """Operations of the UNet forwards of one frame and its crops."""
    from portbench.counts.unet import forward_flops as flops

    cfg = ctx.config
    h, w = cfg["frame"][:2]
    c = cfg["crop_size"]
    return (flops(states["centroid"], (h, w), {"CentroidConfmapsHead":
                                               cfg["centroid"]["confmaps"]["output_stride"]})
            + cfg["max_instances"] * flops(states["instance"], (c, c), {
                "CenteredInstanceConfmapsHead":
                cfg["centered_instance"]["confmaps"]["output_stride"]}))


class _Instruments:
    """The traced run's spans around the program's layers. Two stretches
    follow each other: ``device`` (the device alone: busy and idle time,
    the breakdown; the benchmark notes its own host spans on the host
    clock: the enqueue of a batch, the provider's read) and
    ``kernels`` (host operators too: each fused conv call in a span named by
    its shape, for the kernel's roofline). Both start and stop on the
    thread that enqueues (``predict_async``)."""

    def __init__(self, layer, device, kernels, t_start: float, t_len: float, k_len: float):
        from torch.profiler import record_function

        import sleap_nn_tpu_torch.models.encoder_decoder as ed
        from portbench.counts.fused_conv import span_name

        enqueue, fused = layer.predict_async, ed.fused_double_conv3x3

        def predict_async(*a, **k):
            now = time.perf_counter()
            if not device.running and not device.done and now >= t_start:
                device.start()
            elif device.running and now >= device.started_at + t_len:
                device.stop()
                kernels.start()
            elif kernels.running and now >= kernels.started_at + k_len:
                kernels.stop()
            t_ns = time.time_ns()
            out = enqueue(*a, **k)
            device.note("enqueue", t_ns, time.time_ns())
            return out

        def fused_double_conv3x3(x, w1, b1, w2, b2, **kw):
            if not kernels.running:
                return fused(x, w1, b1, w2, b2, **kw)
            b, h, w, ci = x.shape
            with record_function(span_name(b, h, w, ci, w1.shape[-1], w2.shape[-1],
                                           x.element_size())):
                return fused(x, w1, b1, w2, b2, **kw)

        layer.predict_async = predict_async
        ed.fused_double_conv3x3 = fused_double_conv3x3
        self._restore = lambda: setattr(ed, "fused_double_conv3x3", fused)

    def close(self):
        self._restore()


def run(ctx: RunContext, make_layer: Callable = program_layer) -> Outcome:
    import torch

    from sleap_nn_tpu_torch.inference.predictor import Predictor

    from portbench.core.trace import Tracer

    tr, cfg = ctx.traffic, ctx.config
    bs = tr["batch_size"]
    marks = [("start", ctx.t_process), ("imports", time.perf_counter())]
    pool = build.frame_pool(ctx.seed, [tr["pool_frames"], *cfg["frame"]], ctx.device)
    marks.append(("frame pool", time.perf_counter()))
    layer, states = make_layer(ctx)
    predictor = Predictor(layer, cfg["model_type"], batch_size=bs, device=ctx.device)
    marks.append(("layer", time.perf_counter()))
    predictor.predict(provider=provider(PoolVideo(pool), bs, n_batches=tr["warmup_batches"]),
                      make_labels=False)
    ctx.sync()
    marks.append(("warm-up predict", time.perf_counter()))
    cuda = ctx.device != "cpu"
    tracers = (Tracer(cuda=cuda, lead_s=tr["trace_lead_s"]), Tracer(cuda=cuda, cpu=True)) \
        if ctx.trace else None
    if tracers is not None:
        for tracer in tracers:
            tracer.prepare()
    ctx.sync()
    out = Outcome(setup_s=time.perf_counter() - ctx.t_process)
    marks.append(("window open", time.perf_counter()))
    out.record["setup_marks"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}

    video, done = PoolVideo(pool), []
    predictor.progress_callback = lambda n: done.append((time.perf_counter(), n))
    instruments = None
    t0 = time.perf_counter()
    if tracers is not None:
        t_start, t_len = ctx.trace_span()
        instruments = _Instruments(layer, *tracers, t0 + t_start, t_len, tr["kernel_trace_seconds"])
    results = predictor.predict(provider=provider(
        video, bs, deadline=t0 + ctx.seconds, note=tracers[0].note if tracers else None),
        make_labels=False)
    window_s = time.perf_counter() - t0
    out.memory_peak_bytes = ctx.memory_peak()

    n_done = sum(int(r["valid"].sum()) for r in results)
    lat, prev = [], 0
    for t, n in done:
        lat += [t - video.read_at[j] for j in range(prev, n)]
        prev = n
    out.attempted, out.failed = len(video.read_at), len(video.read_at) - n_done
    out.e2e = {"predict_fps": n_done / window_s,
               "predict_latency_p95_ms": float(np.percentile(lat, 95)) * 1e3 if lat else None}
    out.record.update(window_s=window_s, frames_done=n_done)
    if instruments is not None:
        instruments.close()
        for tracer in tracers:
            if tracer.running:
                tracer.stop()
        # The model step's share of the peak before the first trace began.
        t_cut = tracers[0].started_at or t0 + window_s
        n_cut = max([n for t, n in done if t <= t_cut], default=0)
        out.record.update(untraced_s=t_cut - t0,
                          untraced_flops=n_cut * forward_flops(ctx, states))
        out.trace, out.record["kernel_trace"] = tracers[0].read(), tracers[1].read()

    # Every output with a row a frame, as a list of the frames' rows.
    answers = {k: [row for r in results for row in r[k]] for k, v in
               (results[0].items() if results else ())
               if (isinstance(v, np.ndarray) and v.ndim or isinstance(v, list)) and len(v) == bs}
    del predictor, layer, results
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    out.checks = judge(ctx, pool, states, answers, n_done)
    return out


def judge(ctx: RunContext, pool: np.ndarray, states: Dict, answers: Dict, n_done: int):
    """The judge's numbers for a sample of the completed frames."""
    import torch

    from portbench.reference import topdown

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(build.sub_seed(ctx.seed, 3))
    take = np.sort(rng.choice(n_done, min(ctx.traffic["judged_frames"], n_done), replace=False))
    block = ctx.traffic["judge_block"]
    spec = topdown.TopDownSpec.of(ctx.config, ctx.traffic["precision"])
    blocks = []
    with torch.no_grad():
        for s in range(0, len(take), block):
            rows = take[s:s + block]
            inds = np.asarray([answers["frame_inds"][j] for j in rows]) % len(pool)
            frames = torch.from_numpy(pool[inds]).to(ctx.device)
            blocks.append(topdown.judge(
                states["centroid"], states["instance"], frames,
                {k: np.stack([v[j] for j in rows]) for k, v in answers.items()}, spec))
    numbers: Dict[str, float] = {"frames_judged": len(take)}
    for key in blocks[0]:
        vals = [blk[key] for blk in blocks]
        if key.endswith("_mean"):  # weighted by each block's count
            ns = [blk[key[:-5] + "_n"] for blk in blocks]
            numbers[key] = sum(v * n for v, n in zip(vals, ns)) / max(sum(ns), 1)
        elif key.endswith("_n") or key == "count_err":
            numbers[key] = sum(vals)
        else:
            numbers[key] = max(vals)
    return numbers

