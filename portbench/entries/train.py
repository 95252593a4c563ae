"""Training cells of a bottom-up model: one ``ModelTrainer.train()`` in a
single long epoch.

Set-up makes the labels from the seed (noise frames, 1 to ``max_instances``
instances a frame, about a tenth of the nodes missing), builds the
trainer from the configuration (float32 with TF32 off, Adam, the
geometric augmentation at the package's defaults), puts the benchmark's
own weights into its model (``core/build.py``), and lets ``train()`` run
its first steps: the reference follows the first ``followed_steps``, and
the window opens at the start of step ``warmup_steps``. A callback ends
the window at the first step end past the deadline, after a
``synchronize()``, and stops the trainer; validation falls outside.

- ``train_samples_per_s``: the samples of the steps begun in the window
  over the window's seconds.

The reference then repeats the followed steps from the same weights, on
the frames and instances of the rows the program's loader chose (checked
against the labels, a node outside the frame counting as missing:
``loader_mismatch``, ``rows_repeated``), with the augmentation drawn from
the trainer's seed (``reference/train.py``).
"""

from __future__ import annotations

import gc
import time
from typing import Callable, Dict, List

import numpy as np

from portbench.core import build
from portbench.core.run import Outcome, RunContext


def labels(ctx: RunContext):
    """(train Labels, val Labels, frames (n, H, W, C) uint8, points: a list a
    frame of (I, N, 2) arrays) from the seed."""
    from sleap_nn_tpu_torch.io.model import Instance, LabeledFrame, Labels, Skeleton

    cfg, tr = ctx.config, ctx.traffic
    n = tr["train_frames"] + tr["val_frames"]
    h, w, c = cfg["frame"]
    frames = build.frame_pool(ctx.seed, (n, h, w, c), ctx.device)
    rng = np.random.default_rng(build.sub_seed(ctx.seed, 5))
    names = build.node_names(cfg)
    skel = Skeleton(names, edges=[tuple(e) for e in cfg.get("edges", [])])

    class Video:
        shape = frames.shape

        def __len__(self):
            return len(frames)

        def __getitem__(self, i):
            return frames[i]

        def get_frame(self, i, fmt=None):
            return frames[i]

    # Every seed draws the same numbers of instances, in its own order, so
    # that an epoch holds as many samples whatever the seed.
    k = tr["train_frames"]
    counts = [1 + i % cfg["max_instances"] for i in range(k)]
    counts = list(rng.permutation(counts)) + list(rng.permutation(
        [1 + i % cfg["max_instances"] for i in range(n - k)]))
    video, lfs, points = Video(), [], []
    for f in range(n):
        insts = []
        for _ in range(int(counts[f])):
            centre = rng.uniform(0.1 * w, 0.9 * w, 2)
            pts = centre + rng.normal(0, 0.03 * w, (len(names), 2))
            pts[rng.random(len(names)) < 0.1] = np.nan
            insts.append(pts)
        points.append(np.stack(insts))
        lfs.append(LabeledFrame(video, f, [Instance(p, skel) for p in insts]))
    return Labels(lfs[:k]), Labels(lfs[k:]), frames, points


def trainer_config(ctx: RunContext):
    from sleap_nn_tpu_torch.config import TrainingJobConfig

    cfg, tr = ctx.config, ctx.traffic
    heads = {k: dict(v) for k, v in cfg["bottomup"].items()}
    pre = {"max_height": cfg["frame"][0], "max_width": cfg["frame"][1]}
    return TrainingJobConfig.from_dict({
        "data_config": {"use_augmentations_train": True,
                        "augmentation_config": {"geometric": tr["geometric"]},
                        "preprocessing": pre},
        "model_config": {"backbone_config": {"unet": dict(cfg["backbone"]["unet"])},
                         "head_configs": {"bottomup": heads}},
        "trainer_config": {
            "optimizer_name": "Adam", "optimizer": {"lr": tr["lr"]},
            "seed": build.sub_seed(ctx.seed, 6) % 2**31,
            "train_data_loader": {"batch_size": tr["batch_size"], "shuffle": True},
            "val_data_loader": {"batch_size": tr["batch_size"]},
            "max_epochs": 1, "train_steps_per_epoch": 10**9,
            "save_ckpt": False, "enable_progress_bar": False,
        },
    })


def in_frame(points: np.ndarray, h: int, w: int) -> np.ndarray:
    """A frame's labelled instances (I, N, 2) as the package trains on them:
    a node outside ``[0, w) x [0, h)`` counts as missing (an annotation
    error), and an instance with no node left is dropped."""
    pts = points.astype(np.float32)
    out = (pts[..., 0] < 0) | (pts[..., 0] >= w) | (pts[..., 1] < 0) | (pts[..., 1] >= h)
    pts[out] = np.nan
    return pts[~np.isnan(pts).all(axis=(1, 2))]


def program_trainer(ctx: RunContext, train_labels, val_labels):
    """The trainer, set up, with the benchmark's weights in its model."""
    import torch

    from sleap_nn_tpu_torch.training.model_trainer import ModelTrainer

    trainer = ModelTrainer.get_model_trainer_from_config(
        trainer_config(ctx), [train_labels], [val_labels], device=ctx.device)
    ctx.marks.append(("trainer config", time.perf_counter()))
    trainer.setup()
    gen = torch.Generator(device=ctx.device).manual_seed(build.sub_seed(ctx.seed, 2))
    build.random_init(gen, trainer.model)
    return trainer


class _Window:
    """The benchmark's callback: the followed steps, the window, the trace."""

    def __init__(self, ctx: RunContext, trainer, tracer):
        import torch

        from sleap_nn_tpu_torch.training.callbacks import Callback

        tr = ctx.traffic
        self.ctx = ctx
        self.follow, self.warm = tr["followed_steps"], tr["warmup_steps"]
        self.batches: List[Dict] = []
        self.losses: List = []
        self.first: Dict = {}
        self.after: Dict = {}
        self.samples: List[int] = []
        self.t0 = self.t1 = None
        self.n0 = None
        self.waits: List[float] = []
        self._end_at = None
        self.ends: List[float] = []
        self.followed_at = None
        params = dict(trainer.model.named_parameters())
        step = trainer.train_step

        def train_step(batch):
            n = len(self.samples)
            self.samples.append(int(np.sum(batch["batch_mask"])))
            if n < self.follow:
                self.batches.append({k: np.array(batch[k]) for k in
                                     ("image", "instances", "frame_idx", "batch_mask")})
            t_ns = time.time_ns()
            loss, parts = step(batch)
            if tracer is not None:
                tracer.note("train_step", t_ns, time.time_ns())
            self.losses.append(loss)
            if n == 0:  # Adam's first moment after one step is (1 - beta1) g
                opt = trainer.optimizer
                self.first = {k: opt.state[p].get("exp_avg", torch.zeros_like(p)).detach()
                              / (1 - opt.defaults["betas"][0]) for k, p in params.items()}
            if n == self.follow - 1:
                self.after = {k: p.detach().clone() for k, p in params.items()}
            return loss, parts

        trainer.train_step = train_step
        win = self

        class Hook(Callback):
            def on_batch_start(self, _, i):
                now = time.perf_counter()
                if win._end_at is not None and win.t0 is not None:
                    win.waits.append(now - win._end_at)
                    if tracer is not None:
                        tracer.note("loader_wait", win._end_ns, time.time_ns())
                if i == win.warm and win.t0 is None:
                    win.ctx.sync()
                    win.t0, win.n0 = time.perf_counter(), i
                    start, length = ctx.trace_span()
                    win.trace_at, win.trace_len = win.t0 + start, length
                if tracer is not None and win.t0 is not None:
                    if not tracer.running and not tracer.done and now >= win.trace_at:
                        tracer.start()
                    elif tracer.running and now >= tracer.started_at + win.trace_len:
                        tracer.stop()

            def on_batch_end(self, _, i, logs):
                win._end_at, win._end_ns = time.perf_counter(), time.time_ns()
                win.ends.append(win._end_at)
                if len(win.ends) == win.follow:
                    win.ctx.sync()
                    win.followed_at = time.perf_counter()
                if win.t0 is not None and win.t1 is None and win._end_at >= win.t0 + ctx.seconds:
                    win.ctx.sync()
                    win.t1, win.n1 = time.perf_counter(), i + 1
                    trainer.should_stop = True

        trainer.callbacks.append(Hook())


def run(ctx: RunContext, make_trainer: Callable = program_trainer,
        with_control: bool = False) -> Outcome:
    """One run of a training cell; ``with_control`` also judges the control
    (the reference with TF32 on, in the program's place, on the same rows)
    into ``record["control_checks"]``, for the readings."""
    import torch

    from portbench.core.trace import Tracer
    from portbench.counts.unet import forward_flops
    from portbench.reference import train as ref

    torch.backends.cudnn.allow_tf32 = False  # the configuration's float32
    torch.backends.cuda.matmul.allow_tf32 = False
    tr, cfg = ctx.traffic, ctx.config
    marks = [("start", ctx.t_process), ("imports", time.perf_counter())]
    train_labels, val_labels, frames, points = labels(ctx)
    marks.append(("labels", time.perf_counter()))
    ctx.marks = marks
    trainer = make_trainer(ctx, train_labels, val_labels)
    weights = build.weights(trainer.model)
    marks.append(("trainer set up", time.perf_counter()))
    tracer = Tracer(cuda=ctx.device != "cpu", lead_s=tr["trace_lead_s"]) if ctx.trace else None
    if tracer is not None:
        tracer.prepare()
    win = _Window(ctx, trainer, tracer)
    trainer.train()
    if tracer is not None and tracer.running:
        tracer.stop()
    out = Outcome(setup_s=(win.t0 or time.perf_counter()) - ctx.t_process)
    marks += [("followed steps", win.followed_at), ("window open", win.t0)]
    out.record["setup_marks"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    out.memory_peak_bytes = ctx.memory_peak()
    if win.t1 is None:
        raise RuntimeError("the training window never closed")
    window_s = win.t1 - win.t0
    n_samples = sum(win.samples[win.n0:win.n1])
    losses = torch.stack([torch.as_tensor(v).float().reshape(()) for v in win.losses]).cpu()
    out.attempted = win.n1 - win.n0
    out.failed = int((~torch.isfinite(losses[win.n0:win.n1])).sum())
    out.e2e = {"train_samples_per_s": n_samples / window_s}
    strides, hw = ref.head_strides(cfg), tuple(cfg["frame"][:2])
    out.record.update(window_s=window_s, samples_done=n_samples)
    if tracer is not None:
        # The training step's share of the peak before the trace began.
        t_cut = tracer.started_at or win.t1
        n_cut = sum(1 for t in win.ends[win.n0:] if t <= t_cut)
        out.record.update(loader_wait_s=win.waits, untraced_s=t_cut - win.t0,
                          untraced_flops=3 * sum(win.samples[win.n0:win.n0 + n_cut])
                          * forward_flops(weights, hw, strides))
        out.trace = tracer.read()

    prog = {"losses": [float(v) for v in losses[:win.follow]], "first": win.first,
            "after": win.after}
    batches = win.batches
    del trainer, win
    gc.collect()
    if ctx.device != "cpu":
        torch.cuda.empty_cache()
    out.checks, notes, control = judge(ctx, weights, prog, batches, frames, points,
                                       with_control)
    out.record["judge_notes"] = notes
    if control is not None:
        out.record["control_checks"] = control
    return out


def judge(ctx, weights, prog, batches, frames, points, with_control=False):
    """The reference follows the program's first steps; the loader's rows
    are checked against the labels. Returns the numbers, notes on them, and
    the control's numbers where ``with_control`` (else None)."""
    import torch

    from portbench.reference import train as ref

    dev = ctx.device
    h, w = ctx.config["frame"][:2]
    mismatch, seen = 0, set()
    ref_batches = []
    for b in batches:
        rows = b["frame_idx"].astype(int)
        pts = np.full(b["instances"].shape, np.nan, np.float32)
        for r, f in enumerate(rows):
            kept = in_frame(points[f], h, w)
            pts[r, :len(kept)] = kept
        mismatch += int(not np.array_equal(b["image"], frames[rows]))
        mismatch += int(not np.array_equal(b["instances"], pts, equal_nan=True))
        seen.update(int(f) for f in rows)
        ref_batches.append({
            "frames": torch.from_numpy(frames[rows]).to(dev),
            "points": torch.from_numpy(pts).to(dev),
            "mask": torch.from_numpy(b["batch_mask"].astype(np.float32)).to(dev)})
    n_rows = sum(len(b["frame_idx"]) for b in batches)
    geo = ctx.traffic["geometric"]
    seed = build.sub_seed(ctx.seed, 6) % 2**31
    lr = ctx.traffic["lr"]
    losses, first, after = ref.steps(ctx.config, weights, ref_batches, seed, geo, lr)
    out, notes = ref.judge(prog, losses, first, after, weights)
    out.update(loader_mismatch=mismatch, rows_repeated=n_rows - len(seen))
    control = None
    if with_control:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        try:
            c_losses, c_first, c_after = ref.steps(ctx.config, weights, ref_batches, seed, geo,
                                                   lr)
        finally:
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        control = ref.judge({"losses": c_losses, "first": c_first, "after": c_after},
                            losses, first, after, weights)[0]
    return out, notes, control
