#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``sleap_nn_tpu_torch``) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each of which raises on failure (exit code != 0):

1. Device report: the card's name and power limit.
2. Build: every CUDA kernel of the port, compiled from ``csrc/`` with nvcc
   (one process per source, in parallel).
3. Kernels against their plain PyTorch versions, at the shapes of the two
   paths (UNet medium_rf, 1024x1024 frames, batch 8): the fused double conv
   at all 18 double-conv blocks of one top-down batch in bf16 (plus four
   f32 checks; the bottom-up UNet's 9 blocks have the centroid UNet's
   shapes), the peak NMS on the (8, 512, 512, 1) centroid map (k = 3 and 5)
   and on the (8, 512, 512, 15) bottom-up confmaps (k = 3), bf16 and f32,
   and the PAF line scores on the bottom-up model's own (8, 256, 256, 28)
   PAFs and peaks, bf16 and f32. Times each kernel alone (``graph_ms``:
   bare launches of its C entry into a preallocated output, pre-packed
   weights for the fused conv, in a CUDA graph) and through its wrapper,
   the plain version and, where one exists, the library call that computes
   the same function (cuDNN convolutions), and the bound of each call.
   Counts the tensor-core instructions in the fused conv's SASS
   (``cuobjdump -sass``; it must hold some).
4. Top-down end to end: ``Predictor.predict`` of the top-down pair
   (medium_rf centroid + centered-instance UNets, random weights from a
   seed, bf16) over an in-memory video of 20 synthetic 1024x1024 uint8
   frames, batch 8 (the last batch is partial). Launch counters, zeroed
   just before the run, must show both kernels ran (18 and 1 per batch);
   every output must have the JAX package's shapes, with NaN exactly on
   invalid slots. Prints frames/s and per-stage ms.
5. Bottom-up end to end: ``Predictor.predict`` of a medium_rf bottom-up
   model (confmaps at stride 2, PAFs at stride 4, 15 nodes, 14 edges,
   bf16) over the same 20 frames, with the PAF grouping on the fetch
   thread and then in 2 worker processes. Launch counters must read 9 / 1
   / 1 per batch (fused conv, NMS, PAF line scores) in each run; outputs
   must have the JAX package's keys and shapes, hold at least one
   instance, and be identical between the two runs. Prints frames/s and
   per-stage ms.
6. Agreement with the CPU on a small input: a narrow f32 top-down pair and
   a narrow f32 bottom-up model run on the card and on the CPU; maps must
   agree to 1e-4 and each post-processing stage, fed the same inputs, to
   the index (peaks and PAF scores to 1e-5, instances the same).
7. Centroid training end to end: ``ModelTrainer.train`` of a UNet medium_rf
   centroid model (confmaps at stride 2, sigma 5) on 24 synthetic
   1024x1024 uint8 frames with 1-6 instances of 15 nodes (20 train, 4
   val), batch 4, f32, Adam lr 1e-4, geometric augmentation at its
   defaults, 2 epochs of 5 steps, checkpoints in a temporary directory.
   The kernel-4 launch counter, zeroed before setup, must equal the train
   steps plus the val batches plus the setup probe (the other kernels: 0);
   every loss finite, the parameters moved, ``best.ckpt`` loads strictly
   into a fresh model, ``last.ckpt`` reproduces the trainer's outputs
   exactly, and 20 steps on one fixed batch bring the loss below its
   first value. Prints steps/s, samples/s, peak device memory and the ms
   of one step by stage. The epoch-end evaluation runs after each epoch:
   it renders the val batches again (kernel 4) and finds their centroid
   peaks on the f32 maps (kernel 2), so each adds one launch per val batch
   and epoch; every epoch's logs must hold ``val/dist.avg`` and
   ``val/detection.f1``; on one val batch the peaks through kernel 2 must
   equal those through its plain version exactly. Prints the evaluation's
   seconds per epoch.
8. Training on the card against the CPU: a narrow f32 centroid model
   (filters 8, max_stride 8, 128x128 frames), the same parameters and
   batch, augmentation off: the first loss to 1e-5 relative, every
   gradient to 1e-4 of its largest magnitude, the parameters after 3 Adam
   steps to 1e-5 absolute.
9. Single-instance end to end: ``Predictor.predict`` of a medium_rf
   single-instance model (15 nodes, confmaps at stride 2, random weights
   from a seed, bf16) over the same 20 frames, batch 8. Launch counters
   must read 9 fused-conv calls per batch and 0 for the other kernels;
   outputs must have the JAX package's keys and shapes, every node found.
   Prints frames/s and per-stage ms.
10. Bottom-up training end to end: as phase 7, with the bottom-up model
    (confmaps sigma 2.5 at stride 2, PAFs sigma 15 at stride 4, 15 nodes,
    the 14-edge tree). Kernel 4's launches must equal the train steps plus
    the val batches plus the setup probe, at (4, I, 15, 2) -> (4, 512, 512,
    15); the render is split into its confmap part (kernel 4, held against
    its plain version on the path's own points) and its PAF part.
11. Centered-instance training end to end: as phase 7, with a medium_rf
    centered-instance model (15 nodes, ``crop_size`` 256) on crops of the
    same labels, one sample per instance, and the epoch-end evaluation
    (``val/mOKS`` and ``val/dist.avg`` in every epoch's logs). No kernel
    may launch.
12. Training on the card against the CPU, as phase 8, for a narrow model
    of each of the single-instance, centered-instance and bottom-up types.
13. Predict from model directories: phases 7, 10 and 11 train into dirs
    under one temporary directory (each must hold ``initial_config.yaml``,
    ``training_config.yaml``, ``best.ckpt`` and ``training_log.csv``).
    ``run.predict`` (``load_model`` -> ``Predictor.from_model_paths`` ->
    ``Labels``) runs the top-down pair (dirs of phases 7 + 11) and the
    bottom-up model (phase 10, grouping on the fetch thread) over in-memory
    ``Labels`` of the same 20 frames, bf16, batch 8, no output file. The
    loaded weights must equal the ``state_dict`` saved in ``best.ckpt``
    bit for bit; launch counters must read 18 + 1 (top-down) and 9 + 1 + 1
    (bottom-up) per batch of that run. One ``Predictor.from_model_paths``
    then predicts the frames with ``make_labels=False`` and ``True``: its
    ``Labels``, and ``run.predict``'s, must hold exactly the instances of
    its raw outputs, on every frame. The 10-step models' maps sit near 0,
    so the peak threshold is -1e9 (every local maximum is a peak). Prints
    frames/s, a 3-batch smoke figure.
14. Model dirs on the card against the CPU: a narrow (filters 8, 128x128)
    top-down pair and bottom-up model trained 3 steps on the CPU into dirs
    (their weights then conditioned as in the CPU tests of the model dirs
    and saved by the trainer), predicted through ``run.predict`` on the
    card and on the CPU in f32: counts, validity and NaN placement exact,
    keypoints to 1e-4 px, peak values to 1e-5. ``tools/model_dir_divergence.py``
    runs the same dirs as trained and reports where the two devices part.
15. Tracked predict from model directories: ``run.predict(tracking=True)``
    from phase 13's dirs over the same 20 frames and knobs, with the
    default tracker (launch counters as in phase 13) and with the Kalman
    tracker (6 identities, single-break repair). Every instance carries a
    track, the Kalman run at most 6; each run's tracks equal those of
    ``run_tracker`` on a deep copy of the same path's untracked ``Labels``,
    and provenance holds each run's tracking knobs. Prints frames/s of the
    predict loop and tracking ms per frame, with the card's name and power
    limit.
16. Tracking and evaluation, the card against the CPU: phase 14's narrow
    dirs predict a 24-frame clip of two blob animals on straight paths 64
    px apart with tracking on (each frame's best 2 instances, centroids
    tracked by distance) on both devices: the same track for
    every instance (keypoints to 1e-4 px), and ``run_evaluation`` against
    the clip's ground truth the same (``mOKS`` to 1e-6, ``dist.avg`` to
    1e-4 px, detection counts exact); the metrics file round-trips.
17. Multi-class bottom-up training end to end: as phase 10, with an
    identity model (confmaps sigma 2.5 at stride 2, class maps sigma 5 at
    stride 2, 15 nodes) on phase 7's labels, each instance one of 6
    ``Track``s, distinct within its frame. Kernel 4's launches must equal
    the train steps plus the val batches plus the setup probe; the render
    is split into its confmap part (kernel 4, held against its plain
    version) and its class-map part (plain per-instance confmaps, then the
    max over each class's instances), with the class-map render's peak
    device memory.
18. Multi-class centered-instance training end to end: phase 11 with the
    classes: a class-vectors head (1 dense layer of 64 units on the
    globally max-pooled bottleneck) beside the confmaps, on 256x256 crops,
    with the epoch-end evaluation; ``class_accuracy`` must be in every
    epoch's logs. No kernel may launch.
19. Identity models from model directories: ``run.predict`` from phase
    17's dir (multi-class bottom-up: 9 + 1 launches per batch) and from
    phase 7's centroid dir with phase 18's (multi-class top-down: 18 + 1)
    over phase 13's 20 frames, bf16, batch 8. ``Labels`` must hold exactly
    the raw outputs' instances, each with the ``Track`` of its class, and
    no frame may hold two instances of one track. Then narrow identity
    dirs trained on the CPU predict phase 14's frames on the card and on
    the CPU in f32: validity and NaN placement exact, keypoints to 1e-4 px,
    class probabilities to 1e-5, and the class assignments equal on every
    frame whose rows all clear the bf16 step between their best and
    second-best class probability (the frames left out are counted).

The card machine has no h5py, so the script writes no ``.slp`` file (the
CPU tests hold ``.slp`` files to the JAX package's).

Phase 3 also holds kernel 4 (multi-instance confmaps) against its plain
version at the centroid training shape (4, 6, 1, 2) -> (4, 512, 512, 1)
and the bottom-up one (4, 6, 15, 2) -> (4, 512, 512, 15), and at the
latter with no point and with far points, to 1e-6 with zeros placed
exactly, and reports the share of tiles and terms its cull keeps, as the
kernel counts them (held to the host model of the cull's rule); and
checks that the fused conv refuses a call under autograd. After phase 8 it
breaks the bottom-up ``paf_scoring`` stage down into its parts
(``torch.profiler`` where it sees the device), last so that the profiler
cannot slow the timed phases.

Prints one ``kernels`` JSON line and, last, ``{"ok": true, "device": ...}``.
Without a CUDA device, or without the port package beside it, it exits 1
and prints no result.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BF16 = 989e12  # dense bf16 tensor-core FLOP/s, H100 SXM data sheet
PEAK_F32 = 67e12    # f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # HBM3 bytes/s
IMG, BATCH, N_FRAMES, CROP, MAX_INST, N_NODES = 1024, 8, 20, 256, 6, 15
# Bottom-up skeleton: a branched tree over 15 nodes (edges whose nodes
# exist are kept when a CPU rehearsal sets fewer nodes).
TREE = ((0, 1), (1, 2), (0, 3), (3, 4), (0, 5), (5, 6), (0, 7), (7, 8), (0, 9), (9, 10),
        (2, 11), (2, 12), (4, 13), (4, 14))
MAX_PEAKS, K_PER_NODE, N_POINTS, MIN_LINE = 200, 20, 10, 0.25  # the JAX package's defaults
DEVICE = "cuda"  # a rehearsal on the CPU sets "cpu" and small sizes, then calls the phases
# Phase 7: frames (train + val), their size, batch, epochs x steps, lr.
TRAIN_FRAMES, VAL_FRAMES, TRAIN_IMG, TRAIN_BATCH, TRAIN_EPOCHS, TRAIN_STEPS = 20, 4, 1024, 4, 2, 5
N_CLASSES = 6  # identity models: one track per animal of a full frame


def sync() -> None:
    import torch

    if DEVICE != "cpu":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean device ms of ``fn`` over ``reps`` calls, after one warm-up call."""
    import torch

    fn()
    if DEVICE == "cpu":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(launch, reps: int = 20) -> float:
    """Mean device ms of one ``launch`` call: ``reps`` calls captured in one
    CUDA graph, the graph replayed 5 times between two events. The host's
    per-call work (argument checks, allocation, the ctypes call) is not
    timed. ``launch`` must issue its work on the current stream."""
    import torch

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            launch()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def bound(flops: float, nbytes: float, peak_flops: float):
    """(least ms, what bounds it) for ``flops`` at ``peak_flops`` and ``nbytes`` at HBM rate."""
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bf16_ulp(m: float) -> float:
    """Spacing of bf16 values at magnitude ``m`` (8 significant bits)."""
    return float(2.0 ** (np.floor(np.log2(max(m, 1e-30))) - 7))


# --------------------------------------------------------------------------
# Models of the top-down path
# --------------------------------------------------------------------------


class ArrayVideo:
    """In-memory video: ``__len__`` and ``get_frame(idx, fmt)`` for the
    predictor; ``video[idx]`` and ``.shape`` for the labels model."""

    def __init__(self, frames):
        self.frames = frames
        self.shape = frames.shape

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        return self.frames[idx]

    def get_frame(self, idx, fmt=None):
        return self.frames[idx]


def build_models(cfg_cls, n_nodes, seed, **cfg_kw):
    """Centroid + centered-instance models with random weights from ``seed``.

    Backbone convs get He-normal weights and zero biases, so activations
    keep their scale through the UNet; the 1x1 heads get weights of gain
    0.1 and a 0.5 bias. The maps then vary by about 0.1 around 0.5: a flat
    map would round to one bf16 value and hold no strict maximum, and a
    map that swings negative breaks integral refinement's mass. Centroid
    peaks clear the 0.2 threshold and stage 2 runs on real crops.
    """
    import torch
    from types import SimpleNamespace as ns

    from sleap_nn_tpu_torch.models.model import Model

    cfg = cfg_cls(in_channels=1, output_stride=2, **cfg_kw)
    torch.manual_seed(seed)
    centroid = Model.from_config("unet", cfg, ns(confmaps=ns(
        anchor_part=None, sigma=5.0, output_stride=2, loss_weight=None)), "centroid")
    instance = Model.from_config("unet", cfg, ns(confmaps=ns(
        part_names=[f"n{i}" for i in range(n_nodes)], anchor_part=None, sigma=3.0,
        output_stride=2, loss_weight=None)), "centered_instance")
    random_init(centroid, instance)
    return cfg, centroid, instance


def random_init(*models):
    """He-normal backbone convs with zero biases; 1x1 heads of gain 0.1, bias 0.5."""
    import torch
    from torch import nn

    with torch.no_grad():
        for m in models:
            for conv in m.backbone.modules():
                if isinstance(conv, (nn.Conv2d, nn.ConvTranspose2d)):
                    nn.init.kaiming_normal_(conv.weight, nonlinearity="relu")
                    nn.init.zeros_(conv.bias)
            for layer in m.head_layers:
                for head in layer.values():
                    nn.init.normal_(head[0].weight, std=0.1 * head[0].in_channels ** -0.5)
                    head[0].bias.fill_(0.5)


def build_layer(cfg, centroid, instance, device, use_bf16, crop, max_inst):
    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.inference.layers import (
        CenteredInstanceLayer, CentroidLayer, PostprocessConfig, PreprocessConfig, TopDownLayer)

    pre = PreprocessConfig(ensure_grayscale=True, max_stride=cfg.max_stride)
    kw = dict(use_bf16=use_bf16, output_dtype=None, device=device)
    c_layer = CentroidLayer(TorchBackend(centroid, None, **kw), pre,
                            PostprocessConfig(peak_threshold=0.2, max_instances=max_inst),
                            output_stride=2, device=device)
    i_layer = CenteredInstanceLayer(TorchBackend(instance, None, **kw), pre,
                                    PostprocessConfig(peak_threshold=0.2),
                                    output_stride=2, device=device)
    return TopDownLayer(c_layer, i_layer, max_instances=max_inst, crop_size=crop,
                        device=device)


def bottomup_edges(n_nodes):
    return [e for e in TREE if max(e) < n_nodes]


def build_bottomup_model(cfg_cls, n_nodes, seed, frames, **cfg_kw):
    """A bottom-up model (confmaps at stride 2, PAFs at stride 4, the strides
    the JAX package's config generator writes) with random weights from
    ``seed``, initialised as in :func:`build_models`: the 0.5 head biases put
    confmap peaks above the threshold and PAF vectors at (0.5, 0.5), so
    lines that run right or down score above ``MIN_LINE``.

    Random heads give each confmap channel its own offset and spread, and
    the per-sample top-K of local peaks would then come from one or two
    channels. So the confmap head is moved per channel, on ``frames``: the
    median to 0.5 and the (max_peaks / n_nodes)-th highest local peak of a
    sample to 0.9 (mean over samples), and every node gets its share.
    """
    import torch
    from types import SimpleNamespace as ns

    from sleap_nn_tpu_torch.inference.layers import PreprocessConfig, preprocess_images
    from sleap_nn_tpu_torch.models.model import Model
    from sleap_nn_tpu_torch.ops.kernels import nms_scores

    cfg = cfg_cls(in_channels=1, output_stride=2, **cfg_kw)
    names = [f"n{i}" for i in range(n_nodes)]
    torch.manual_seed(seed)
    model = Model.from_config("unet", cfg, ns(
        confmaps=ns(part_names=names, sigma=2.5, output_stride=2, loss_weight=None),
        pafs=ns(edges=[(names[s], names[d]) for s, d in bottomup_edges(n_nodes)],
                sigma=15.0, output_stride=4, loss_weight=None)), "bottomup")
    random_init(model)
    model.to(DEVICE)
    head = model.head_layers[0]["MultiInstanceConfmapsHead"][0]
    with torch.no_grad():
        x, _ = preprocess_images(PreprocessConfig(ensure_grayscale=True, max_stride=cfg.max_stride),
                                 torch.from_numpy(frames).to(DEVICE))
        cms = model(x)["MultiInstanceConfmapsHead"].contiguous()
        peaks = nms_scores(cms, -1e9).permute(0, 3, 1, 2).flatten(2)  # (B, C, H*W)
        top = peaks.topk(MAX_PEAKS // n_nodes, dim=-1).values[..., -1].mean(dim=0)
        median = cms.flatten(0, 2).median(dim=0).values
        gain = 0.4 / (top - median)
        head.weight.mul_(gain[:, None, None, None])
        head.bias.copy_((head.bias - median) * gain + 0.5)
    return cfg, model


def build_bottomup_layer(cfg, model, device, use_bf16, max_inst):
    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.inference.layers import (
        BottomUpLayer, PostprocessConfig, PreprocessConfig)
    from sleap_nn_tpu_torch.inference.paf_grouping import PAFScorer

    cm_head, paf_head = model.heads
    scorer = PAFScorer(cm_head.part_names, paf_head.edges, pafs_stride=paf_head.output_stride,
                       n_points=N_POINTS, min_line_scores=MIN_LINE, k_per_node=K_PER_NODE)
    post = PostprocessConfig(peak_threshold=0.2, max_peaks=MAX_PEAKS, max_instances=max_inst,
                             k_per_node=K_PER_NODE, n_points=N_POINTS, min_line_scores=MIN_LINE)
    return BottomUpLayer(
        TorchBackend(model, None, use_bf16=use_bf16, output_dtype=None, device=device),
        PreprocessConfig(ensure_grayscale=True, max_stride=cfg.max_stride), post, scorer,
        cm_output_stride=cm_head.output_stride, device=device)


def smoke_frames():
    """The end-to-end phases' 20 synthetic uint8 frames."""
    return np.random.default_rng(0).integers(0, 256, (N_FRAMES, IMG, IMG, 1), dtype=np.uint8)


def fused_shapes(model, batch: int, size: int):
    """(name, x shape, conv0, conv1) of every fused double-conv call of one forward."""
    bb = model.backbone
    out = []
    for b, blk in enumerate(bb.encoders[0].encoder_stack):
        c0, c1 = list(blk.blocks.values())
        s = size >> b
        out.append((f"enc{b}", (batch, s, s, c0.in_channels), c0, c1))
    dec = bb.decoders[0]
    for b, blk in enumerate(dec.decoder_stack):
        c0, c1 = list(blk.blocks.values())[-2:]
        s = size // dec.strides[b]
        out.append((f"dec{b}", (batch, s, s, c0.in_channels), c0, c1))
    return out


# --------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# --------------------------------------------------------------------------


def sass_tensor_ops(kernel):
    """Counts of tensor-core instructions (HMMA, HGMMA) in a built kernel's
    SASS, from ``cuobjdump -sass``; None where the toolkit has no cuobjdump."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", str(kernel.library)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    return {name: len(re.findall(rf"\b{name}\.", sass)) for name in ("HMMA", "HGMMA")}


def check_fused(layer, rng):
    import torch
    import torch.nn.functional as F

    from sleap_nn_tpu_torch.models.encoder_decoder import hwio
    from sleap_nn_tpu_torch.ops.fused_conv import (
        _launch, _pack, _packed, _plain_double_conv, fused_double_conv3x3, plan_tiles)

    c_model = layer.centroid_layer.backend.model
    i_model = layer.instance_layer.backend.model
    calls = ([("centroid", *s) for s in fused_shapes(c_model, BATCH, IMG)]
             + [("instance", *s) for s in fused_shapes(i_model, BATCH * MAX_INST, CROP)])
    f32_checks = {("centroid", n) for n in ("enc0", "enc4", "dec0", "dec3")}
    rows = []
    for model_name, name, shape, c0, c1 in calls:
        for dtype in (torch.bfloat16, torch.float32):
            if dtype == torch.float32 and (model_name, name) not in f32_checks:
                continue
            # Inputs as the path sees them: an image in [0, 1), else ReLU features.
            x = rng.random(shape, dtype=np.float32) if shape[-1] == 1 else \
                np.maximum(rng.standard_normal(shape, dtype=np.float32), 0)
            x = torch.from_numpy(x).to(DEVICE, dtype)
            # Detached: the fused kernel has no backward and refuses autograd inputs.
            w1, b1 = hwio(c0.weight).detach().to(dtype), c0.bias.detach().to(dtype)
            w2, b2 = hwio(c1.weight).detach().to(dtype), c1.bias.detach().to(dtype)
            got = fused_double_conv3x3(x, w1, b1, w2, b2)
            want = _plain_double_conv(x, w1, b1, w2, b2)
            sync()
            err = (got.float() - want.float()).abs().max().item()
            top = want.float().abs().max().item()
            tol = bf16_ulp(top) if dtype == torch.bfloat16 else 1e-4 * top
            bsz, h, w, cin = shape
            cmid, cout = c0.out_channels, c1.out_channels
            itemsize = 2 if dtype == torch.bfloat16 else 4
            flops = 2.0 * bsz * h * w * 9 * (cin * cmid + cmid * cout)
            nbytes = (bsz * h * w * (cin + cout) + 9 * (cin * cmid + cmid * cout)) * itemsize \
                + 4 * (cmid + cout)
            bound_ms, bound_by = bound(flops, nbytes,
                                       PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
            xc = x.permute(0, 3, 1, 2)
            wc1 = c0.weight.detach().to(dtype).contiguous(memory_format=torch.channels_last)
            wc2 = c1.weight.detach().to(dtype).contiguous(memory_format=torch.channels_last)
            wrapper_ms = cuda_ms(lambda: fused_double_conv3x3(x, w1, b1, w2, b2))
            if DEVICE == "cpu":  # a rehearsal has no kernel to launch
                kernel_ms = wrapper_ms
            else:
                # The kernel alone: pre-packed weights, a preallocated output, in a graph.
                pw1, pw2 = _packed(w1, b1, dtype), _packed(w2, b2, dtype)
                out = torch.empty_like(got)
                kernel_ms = graph_ms(lambda: _launch(x, pw1, pw2, out, cmid, "relu"))
                if not torch.equal(out, got):
                    raise AssertionError(f"fused_double_conv3x3: the timed graph differs at {name}")
            plan = plan_tiles(*shape, cmid, cout) if dtype == torch.bfloat16 else None
            row = dict(
                model=model_name, block=name, dtype=str(dtype).split(".")[-1],
                x=list(shape), c_mid=cmid, c_out=cout, max_abs_err=err, tol=tol,
                err_ulps=err / bf16_ulp(top) if dtype == torch.bfloat16 else None,
                frac_diff=(got != want).float().mean().item(), ok=bool(err <= tol),
                tile=[plan.tile_h, plan.tile_w] if plan else [8, 16],
                smem_bytes=plan.smem_bytes if plan else None,
                kernel_ms=kernel_ms, wrapper_ms=wrapper_ms,
                pack_ms=cuda_ms(lambda: (_pack(w1, b1, dtype), _pack(w2, b2, dtype))),
                plain_ms=cuda_ms(lambda: _plain_double_conv(x, w1, b1, w2, b2), reps=2),
                library_ms=cuda_ms(lambda: F.relu(F.conv2d(
                    F.relu(F.conv2d(xc, wc1, b1, padding=1)), wc2, b2, padding=1))),
                bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
                tflops=flops / kernel_ms / 1e9,
            )
            log("fused_double_conv3x3 " + json.dumps(row))
            rows.append(row)
            del x, got, want
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"fused_double_conv3x3 disagrees with its plain version: {bad}")
    return rows


def check_nms(rng, channels=1, ks=(3, 5)):
    import torch

    from sleap_nn_tpu_torch.ops.kernels import NMS_SCORES, _plain_nms_scores, nms_scores

    rows = []
    shape = (BATCH, IMG // 2, IMG // 2, channels)
    base = torch.from_numpy(rng.random(shape, dtype=np.float32)).to(DEVICE)
    for dtype in (torch.bfloat16, torch.float32):
        cms = base.to(dtype)
        for k in ks:
            got = nms_scores(cms, 0.2, kernel=k)
            want = _plain_nms_scores(cms, 0.2, kernel=k)
            sync()
            same = torch.equal(got, want)
            itemsize = 2 if dtype == torch.bfloat16 else 4
            n = cms.numel()
            bound_ms, bound_by = bound(float(n * k * k), n * (itemsize + 4), PEAK_F32)
            wrapper_ms = cuda_ms(lambda: nms_scores(cms, 0.2, kernel=k), reps=20)
            if DEVICE == "cpu":  # a rehearsal has no kernel to launch
                kernel_ms = wrapper_ms
            else:
                # The kernel alone: its C entry into a preallocated output, in a graph.
                out = torch.empty_like(got)
                kernel_ms = graph_ms(lambda: NMS_SCORES.launch(
                    cms.data_ptr(), out.data_ptr(), *shape, k, 0.2,
                    int(dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream))
                if not torch.equal(out, got):
                    raise AssertionError("nms_scores: the timed graph differs")
            row = dict(dtype=str(dtype).split(".")[-1], x=list(shape), kernel=k,
                       exact=same, n_peaks=int(torch.isfinite(got).sum()),
                       max_abs_err=0.0 if same else float("inf"),
                       kernel_ms=kernel_ms, wrapper_ms=wrapper_ms,
                       plain_ms=cuda_ms(lambda: _plain_nms_scores(cms, 0.2, kernel=k), reps=5),
                       library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
            log("nms_scores " + json.dumps(row))
            rows.append(row)
    if not all(r["exact"] for r in rows):
        raise AssertionError(f"nms_scores differs from its plain version: {rows}")
    return rows


def paf_inputs(layer, frames):
    """The bottom-up path's own PAFs, grouped peaks and mask for one batch."""
    import torch

    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.inference.paf_grouping import group_peaks_by_node
    from sleap_nn_tpu_torch.ops.peaks import find_local_peaks

    post, scorer = layer.post, layer.paf_scorer
    with torch.inference_mode():
        x, _ = preprocess_images(layer.pre, torch.from_numpy(frames).to(DEVICE))
        preds = layer.backend(x)
        pts, vals, chans, valid = find_local_peaks(
            preds[layer.cm_head], threshold=post.peak_threshold, refinement=post.refinement,
            integral_patch_size=post.integral_patch_size, max_peaks=post.max_peaks)
        gp, _, mask = group_peaks_by_node(pts * layer.cm_output_stride, vals, chans, valid,
                                          scorer.n_nodes, scorer.k_per_node)
    return preds[layer.paf_head], gp, mask


def check_paf(layer, frames):
    import torch

    from sleap_nn_tpu_torch.inference.paf_grouping import line_fractions
    from sleap_nn_tpu_torch.ops.kernels import (
        _launch_paf_line_scores, _plain_paf_line_scores, paf_line_scores, paf_line_subscripts)

    scorer = layer.paf_scorer
    pafs, gp, mask = paf_inputs(layer, frames)
    b, hp, wp, _ = pafs.shape
    edges = torch.tensor(scorer.edge_inds, dtype=torch.int32, device=DEVICE)
    t = line_fractions(scorer.n_points, DEVICE)
    max_len = scorer.max_edge_length_ratio * max(hp, wp, 2 * scorer.n_edges) * scorer.pafs_stride
    src, dst = gp[:, edges[:, 0].long()], gp[:, edges[:, 1].long()]
    ys, xs = paf_line_subscripts(src, dst, t, scorer.pafs_stride, hp, wp)
    b_idx = torch.arange(b, device=DEVICE)[:, None, None, None, None]
    e_idx = torch.arange(scorer.n_edges, device=DEVICE)[None, :, None, None, None]
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        p = pafs.to(dtype).contiguous()
        args = (p, gp, mask, edges, t, scorer.pafs_stride, max_len, scorer.dist_penalty_weight)
        got = paf_line_scores(*args)
        want = _plain_paf_line_scores(*args)
        sync()
        fin = torch.isfinite(want)
        err = (got[fin] - want[fin]).abs().max().item() if fin.any() else 0.0
        placed = bool(torch.equal(torch.isneginf(got), torch.isneginf(want))
                      and torch.equal(torch.isnan(got), torch.isnan(want)))
        # This run's data: a pair with an invalid end loads nothing.
        n_pairs = int((~torch.isneginf(want)).sum())
        itemsize = p.element_size()
        nbytes = (n_pairs * scorer.n_points * 2 * itemsize + gp.numel() * 4 + mask.numel()
                  + got.numel() * 4)
        flops = n_pairs * (10.0 * scorer.n_points + 10.0)
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32)
        wrapper_ms = cuda_ms(lambda: paf_line_scores(*args), reps=20)
        if DEVICE == "cpu":  # a rehearsal has no kernel to launch
            kernel_ms = wrapper_ms
        else:
            # The kernel alone: its C entry into a preallocated output, in a graph.
            out = torch.empty_like(got)
            kernel_ms = graph_ms(lambda: _launch_paf_line_scores(
                p, gp, mask, edges, t, out, scorer.pafs_stride, max_len,
                scorer.dist_penalty_weight))
            if not torch.equal(out.nan_to_num(), got.nan_to_num()):
                raise AssertionError("paf_line_scores: the timed graph differs")
        row = dict(
            dtype=str(dtype).split(".")[-1], pafs=list(p.shape), peaks=list(gp.shape),
            scores=list(got.shape), peaks_per_node=mask.sum(dim=-1).float().mean(dim=0).tolist(),
            valid_pairs=n_pairs, finite_scores=int(fin.sum()),
            above_min_line=int((want >= MIN_LINE).sum()), max_abs_err=err, tol=1e-5,
            inf_nan_placement_exact=placed, ok=bool(placed and err <= 1e-5),
            kernel_ms=kernel_ms, wrapper_ms=wrapper_ms,
            plain_ms=cuda_ms(lambda: _plain_paf_line_scores(*args), reps=5),
            # Covers only the sampling the TPU kernel did, not the scoring.
            gather_ms=cuda_ms(lambda: (p[b_idx, ys, xs, 2 * e_idx],
                                       p[b_idx, ys, xs, 2 * e_idx + 1]), reps=5),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by, flops=flops, bytes=nbytes,
        )
        log("paf_line_scores " + json.dumps(row))
        rows.append(row)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise AssertionError(f"paf_line_scores disagrees with its plain version: {bad}")
    if not all(r["above_min_line"] > 0 for r in rows):
        raise AssertionError("no pair scores above min_line_scores: the smoke maps are degenerate")
    return rows


def paf_scoring_breakdown(layer, frames):
    """Where the bottom-up ``paf_scoring`` stage's time goes, on one batch:
    ms per call, each call fenced by ``synchronize()`` (the stage's own
    clock), of the stage as the path runs it (``PAFScorer.score_lines``,
    device ``t`` cached), of ``score_paf_lines_dense`` building ``t`` anew,
    and of each part alone; the wrapper's host ms per call unfenced; and,
    where ``torch.profiler`` sees the device, its per-op totals."""
    import torch

    from sleap_nn_tpu_torch.inference.paf_grouping import line_fractions, score_paf_lines_dense
    from sleap_nn_tpu_torch.ops.kernels import _launch_paf_line_scores, paf_line_scores

    scorer = layer.paf_scorer
    pafs, gp, mask = paf_inputs(layer, frames)  # the PAF head's output as the layer gets it
    hp, wp = pafs.shape[1:3]
    edges, t = scorer._edge_inds_on(pafs.device), scorer._line_fractions_on(pafs.device)
    max_len = scorer.max_edge_length_ratio * max(hp, wp, 2 * scorer.n_edges) * scorer.pafs_stride
    kw = dict(n_line_points=scorer.n_points, pafs_stride=scorer.pafs_stride,
              max_edge_length_ratio=scorer.max_edge_length_ratio,
              dist_penalty_weight=scorer.dist_penalty_weight)

    def fenced_ms(fn, reps=50):
        total = 0.0
        fn()
        for _ in range(reps):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            total += time.perf_counter() - t0
        return total * 1e3 / reps

    def host_ms(fn, reps=200):
        fn()
        sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host = (time.perf_counter() - t0) * 1e3 / reps
        sync()
        return host

    wrapper = lambda: paf_line_scores(pafs, gp, mask, edges, t, scorer.pafs_stride, max_len,  # noqa: E731
                                      scorer.dist_penalty_weight)
    scores = wrapper()
    with torch.inference_mode():
        out = {
            "pafs": list(pafs.shape), "pafs_dtype": str(pafs.dtype).split(".")[-1],
            "pafs_contiguous": pafs.is_contiguous(), "pafs_strides": list(pafs.stride()),
            "stage_cached_t_ms": fenced_ms(lambda: scorer.score_lines(pafs, gp, mask)),
            "stage_new_t_ms": fenced_ms(lambda: score_paf_lines_dense(pafs, gp, mask, edges, **kw)),
            "line_fractions_ms": fenced_ms(lambda: line_fractions(scorer.n_points, pafs.device)),
            "contiguous_ms": fenced_ms(pafs.contiguous),
            "wrapper_ms": fenced_ms(wrapper),
            "fence_only_ms": fenced_ms(lambda: None),
            "wrapper_host_ms": host_ms(wrapper),
            "stage_host_ms": host_ms(lambda: scorer.score_lines(pafs, gp, mask)),
            # The wrapper's parts on the host: allocating the output, asking
            # for the stream, and the ctypes call that launches.
            "host_empty_ms": host_ms(lambda: torch.empty_like(scores)),
            "host_current_stream_ms": host_ms(lambda: torch.cuda.current_stream().cuda_stream
                                              if DEVICE != "cpu" else None),
        }
        if DEVICE != "cpu":
            out["host_launch_ms"] = host_ms(lambda: _launch_paf_line_scores(
                pafs, gp, mask, edges, t, scores, scorer.pafs_stride, max_len,
                scorer.dist_penalty_weight))
        if DEVICE != "cpu":
            try:
                from torch.profiler import ProfilerActivity, profile

                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for _ in range(20):
                        scorer.score_lines(pafs, gp, mask)
                    sync()
                ops = []
                for ev in prof.key_averages():
                    dev_us = getattr(ev, "self_device_time_total",
                                     getattr(ev, "self_cuda_time_total", 0.0))
                    ops.append({"name": ev.key[:60], "count": ev.count,
                                "cpu_us_per_call": ev.cpu_time_total / max(ev.count, 1),
                                "self_device_us_per_call": dev_us / max(ev.count, 1)})
                ops.sort(key=lambda o: -o["cpu_us_per_call"] * o["count"])
                out["profiler"] = ops[:12]
                out["profiler_device_us_per_stage"] = sum(
                    o["self_device_us_per_call"] * o["count"] for o in ops) / 20
            except Exception as exc:  # the profiler is a report, not a check
                out["profiler"] = f"failed: {exc!r}"
    log("paf_scoring_breakdown " + json.dumps(out))
    return out


def confmap_cases():
    """Kernel 4's cases: (name, nodes, sigma at output stride 2, points)."""
    return (("centroid_train", 1, 5.0, "uniform"), ("bottomup_train", N_NODES, 2.5, "uniform"),
            ("all_nan", N_NODES, 2.5, "all_nan"), ("far_points", N_NODES, 2.5, "far_points"))


def confmap_points(rng, n_nodes, case):
    """Training-target points (TRAIN_BATCH, MAX_INST, n_nodes, 2) of one case:
    uniform over the frame with NaN nodes and two padding instances;
    ``all_nan`` has no point at all, ``far_points`` puts most of them far
    outside the grid (one at x = +inf, whose non-finite bound keeps it)."""
    pts = rng.uniform(0, TRAIN_IMG, (TRAIN_BATCH, MAX_INST, n_nodes, 2)).astype(np.float32)
    pts[rng.random((TRAIN_BATCH, MAX_INST, n_nodes)) < 0.2] = np.nan  # NaN nodes
    pts[:, MAX_INST - 2:] = np.nan  # padding instances
    if case == "all_nan":
        pts[:] = np.nan
    if case == "far_points":
        pts[:, : MAX_INST - 3] += np.float32(3 * TRAIN_IMG)
        pts[0, MAX_INST - 3, 0] = [np.inf, 5.0]
    return pts


def needed_terms(pts, xv, yv, sigma):
    """(pixel, point) pairs whose Gaussian term is not exactly 0 in f32
    (d^2 / denom below 103.97): the terms this run's data needs."""
    import torch

    denom = 2 * sigma**2
    p = pts.reshape(-1, 2)
    p = p[torch.isfinite(p).all(dim=1)]
    total = 0
    for q in p:
        d2 = (xv[None, :] - q[0]) ** 2 + (yv[:, None] - q[1]) ** 2
        total += int((d2 < 103.97 * denom).sum())
    return total


def check_confmaps(rng):
    """Kernel 4 against its plain version at the training shapes (NaN
    instances and nodes included), and with no point and with far points:
    zeros placed exactly (0 wherever the plain version is 0, > 0 wherever
    it is >= 1e-30), the rest to 1e-6. Reports the share of tiles and terms
    that the kernel's cull keeps, as the kernel counts them, and holds the
    counts to the host model of the cull's rule."""
    import torch

    from sleap_nn_tpu_torch.ops.grid import make_grid_vectors
    from sleap_nn_tpu_torch.ops.kernels import (
        _launch_multi_confmaps, _plain_multi_confmaps, confmap_cull_counts, confmap_tile,
        multi_confmaps)

    rows = []
    for path, n_nodes, sigma, case in confmap_cases():
        pts = torch.from_numpy(confmap_points(rng, n_nodes, case)).to(DEVICE)
        xv, yv = make_grid_vectors(TRAIN_IMG, TRAIN_IMG, 2, device=DEVICE)
        args = (pts, xv, yv, sigma * 2)
        got = multi_confmaps(*args)
        want = _plain_multi_confmaps(*args)
        sync()
        err = (got - want).abs().max().item()
        zeros_exact = bool((got[want == 0] == 0).all() and (got[want >= 1e-30] > 0).all())
        wrapper_ms = cuda_ms(lambda: multi_confmaps(*args), reps=20)
        if DEVICE == "cpu":  # a rehearsal has no kernel to launch
            kernel_ms = wrapper_ms
        else:
            # The kernel alone: its C entry into a preallocated output, in a graph.
            out = torch.empty_like(got)
            kernel_ms = graph_ms(lambda: _launch_multi_confmaps(pts, xv, yv, out, sigma * 2))
            if not torch.equal(out, got):
                raise AssertionError(f"multi_confmaps: the timed graph did not render {path}")
        # What the cull keeps: tiles with a live point, and terms computed
        # (live points x the tile's pixels) against every term (I x N per
        # pixel). The kernel counts them; the host model must agree.
        model_tiles, model_terms, n_tiles = confmap_cull_counts(*args)
        if DEVICE == "cpu":  # a rehearsal has no kernel to count
            live_tiles, computed = model_tiles, model_terms
        else:
            stats = torch.zeros(2, dtype=torch.int64, device=DEVICE)
            _launch_multi_confmaps(pts, xv, yv, out, sigma * 2, stats)
            live_tiles, computed = stats.tolist()
            if not torch.equal(out, got):
                raise AssertionError(f"multi_confmaps: the counting launch differs on {path}")
        cull_as_modelled = (live_tiles, computed) == (model_tiles, model_terms)
        all_terms = got.numel() * pts.shape[1]
        needed = needed_terms(pts, xv, yv, sigma * 2)
        # This run's data: one Gaussian term per (pixel, point) it reaches.
        flops = 10.0 * needed
        nbytes = got.numel() * 4 + pts.numel() * 4 + (xv.numel() + yv.numel()) * 4
        bound_ms, bound_by = bound(flops, nbytes, PEAK_F32)
        row = dict(path=path, points=list(pts.shape), out=list(got.shape), sigma=sigma * 2,
                   valid_points=int(torch.isfinite(pts).all(dim=-1).sum()),
                   tile=list(confmap_tile(n_nodes)), tiles_live=live_tiles, tiles_all=n_tiles,
                   tiles_live_share=live_tiles / n_tiles, terms_computed=computed,
                   terms_all=all_terms, terms_needed=needed,
                   terms_computed_share=computed / all_terms,
                   cull_counted_by="host model" if DEVICE == "cpu" else "kernel",
                   cull_as_modelled=cull_as_modelled,
                   max_abs_err=err, tol=1e-6, zeros_exact=zeros_exact,
                   ok=bool(err <= 1e-6 and zeros_exact and cull_as_modelled),
                   max_value=got.max().item(), kernel_ms=kernel_ms, wrapper_ms=wrapper_ms,
                   plain_ms=cuda_ms(lambda: _plain_multi_confmaps(*args), reps=5),
                   library_ms=None, bound_ms=bound_ms, bound_by=bound_by, flops=flops,
                   bytes=nbytes)
        log("multi_confmaps " + json.dumps(row))
        rows.append(row)
    bad = [r for r in rows if not r["ok"] or r["max_value"] < (0 if r["path"] == "all_nan" else 0.5)]
    if bad:
        raise AssertionError(f"multi_confmaps disagrees with its plain version: {bad}")
    return rows


def check_fused_refuses_autograd():
    """The fused conv has no backward: under autograd it must raise."""
    import torch

    from sleap_nn_tpu_torch.ops.fused_conv import fused_double_conv3x3

    x = torch.rand(1, 8, 8, 2, device=DEVICE)
    w = torch.rand(3, 3, 2, 2, device=DEVICE, requires_grad=True)
    try:
        fused_double_conv3x3(x, w, None, w, None)
    except RuntimeError as exc:
        log(f"fused_double_conv3x3 under autograd raises: {exc}")
        return
    if DEVICE != "cpu":  # the CPU takes the plain version, which has autograd
        raise AssertionError("fused_double_conv3x3 ran under autograd")


# --------------------------------------------------------------------------
# Phase 4: end to end
# --------------------------------------------------------------------------


def check_outputs(results):
    """JAX package shapes; NaN exactly on invalid slots."""
    assert len(results) == -(-N_FRAMES // BATCH), len(results)
    for i, out in enumerate(results):
        kp, vals = out["pred_keypoints"], out["pred_peak_values"]
        valid = out["instance_valid"]
        assert kp.shape == (BATCH, MAX_INST, N_NODES, 2) and kp.dtype == np.float32, kp.shape
        assert vals.shape == (BATCH, MAX_INST, N_NODES), vals.shape
        assert out["pred_centroids"].shape == (BATCH, MAX_INST, 2)
        assert out["centroid_vals"].shape == (BATCH, MAX_INST)
        assert valid.shape == (BATCH, MAX_INST) and valid.dtype == bool
        assert valid.any(), "no centroid found: stage 2 ran on empty crops only"
        assert np.isnan(kp[~valid]).all() and (vals[~valid] == 0).all()
        assert np.isfinite(out["pred_centroids"][valid]).all()
        assert np.isnan(out["pred_centroids"][~valid]).all()
        # Heads biased to 0.5 put every node above the threshold.
        assert np.isfinite(kp[valid]).all()
        assert (np.abs(kp[valid] - IMG / 2) <= IMG / 2 + CROP).all()
        n_valid = min(BATCH, N_FRAMES - i * BATCH)
        assert out["valid"].tolist() == [True] * n_valid + [False] * (BATCH - n_valid)
        assert out["frame_inds"][:n_valid].tolist() == list(range(i * BATCH, i * BATCH + n_valid))


def stage_times(layer, frames):
    """Per-stage ms of one batch, each stage fenced by synchronize()."""
    import torch

    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.ops.crops import crop_bboxes, make_centered_bboxes
    from sleap_nn_tpu_torch.ops.peaks import find_global_peaks, find_local_peaks

    c, inst = layer.centroid_layer, layer.instance_layer
    images = torch.from_numpy(frames).to(DEVICE)
    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            x, _eff = timed("preprocess", lambda: preprocess_images(c.pre, images))
            cms = timed("centroid_unet", lambda: c.backend(x)[c.head_name])
            pts = timed("centroid_peaks", lambda: find_local_peaks(
                cms, threshold=0.2, refinement="integral", max_peaks=MAX_INST)[0])
            cent = torch.nan_to_num(pts * 2, nan=-1e6).reshape(-1, 2)
            crops = timed("crop", lambda: crop_bboxes(
                x, make_centered_bboxes(cent, CROP, CROP),
                torch.arange(BATCH, device=DEVICE).repeat_interleave(MAX_INST), CROP, CROP))
            icms = timed("instance_unet", lambda: inst.backend(crops)[inst.head_name])
            timed("instance_peaks", lambda: find_global_peaks(
                icms, threshold=0.2, refinement="integral"))
    return times


def run_end_to_end(layer, kernels):
    import torch

    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import VideoProvider

    frames = smoke_frames()
    video = ArrayVideo(frames)
    predictor = Predictor(layer, "topdown", batch_size=BATCH, device=DEVICE)
    predictor.predict(provider=VideoProvider(ArrayVideo(frames[:BATCH]), batch_size=BATCH),
                      make_labels=False)  # warm-up: allocator, cuDNN
    sync()
    for k in kernels.values():
        k.launches = 0
    results = predictor.predict(provider=VideoProvider(video, batch_size=BATCH),
                                make_labels=False)
    launches = {name: k.launches for name, k in kernels.items()}
    n_batches = len(results)
    want = {"fused_double_conv3x3": 18 * n_batches, "nms_scores": n_batches,
            "paf_line_scores": 0, "multi_confmaps": 0}
    if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
        raise AssertionError(f"launch counts {launches}, expected {want}")
    check_outputs(results)
    stats = dict(predictor.last_stats)
    stats["instances"] = int(sum(r["instance_valid"][r["valid"]].sum() for r in results))
    stats["stage_ms"] = stage_times(layer, frames[:BATCH])
    stats["launches"] = launches
    stats["n_batches"] = n_batches
    log("end_to_end " + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# Phase 5: bottom-up end to end
# --------------------------------------------------------------------------

BOTTOMUP_KEYS = {"pred_keypoints", "pred_peak_values", "pred_instance_scores",
                 "frame_inds", "video_inds", "valid"}


def check_bottomup_outputs(results, n_nodes):
    """The JAX package's keys and per-sample shapes; returns the instance count."""
    assert len(results) == -(-N_FRAMES // BATCH), len(results)
    n_inst = 0
    for i, out in enumerate(results):
        assert set(out) == BOTTOMUP_KEYS, sorted(out)
        for key in ("pred_keypoints", "pred_peak_values", "pred_instance_scores"):
            assert len(out[key]) == BATCH, (key, len(out[key]))
        for kp, vals, sc in zip(out["pred_keypoints"], out["pred_peak_values"],
                                out["pred_instance_scores"]):
            n = kp.shape[0]
            assert n <= MAX_INST, n
            assert kp.shape == (n, n_nodes, 2) and kp.dtype == np.float32, kp.shape
            assert vals.shape == (n, n_nodes) and sc.shape == (n,), (vals.shape, sc.shape)
            found = np.isfinite(kp).all(axis=-1)
            assert (found == np.isfinite(vals)).all() and (found.sum(axis=-1) >= 2).all()
            assert (np.abs(kp[found] - IMG / 2) <= IMG / 2).all()
        n_valid = min(BATCH, N_FRAMES - i * BATCH)
        assert out["valid"].tolist() == [True] * n_valid + [False] * (BATCH - n_valid)
        assert out["frame_inds"][:n_valid].tolist() == list(range(i * BATCH, i * BATCH + n_valid))
        n_inst += sum(len(kp) for kp, v in zip(out["pred_keypoints"], out["valid"]) if v)
    assert n_inst >= 1, "no instance found in any frame"
    return n_inst


def assert_same_outputs(a, b):
    """Identical per-batch outputs (NaN equal to NaN)."""
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert set(x) == set(y)
        for key in x:
            xs, ys = (x[key], y[key]) if isinstance(x[key], list) else ([x[key]], [y[key]])
            assert len(xs) == len(ys), key
            for u, v in zip(xs, ys):
                assert u.dtype == v.dtype and np.array_equal(u, v, equal_nan=u.dtype.kind == "f"), key


def bottomup_stage_times(layer, frames):
    """Per-stage ms of one bottom-up batch, each stage fenced by synchronize()."""
    import torch

    from sleap_nn_tpu_torch.inference.layers import preprocess_images, to_host
    from sleap_nn_tpu_torch.inference.paf_grouping import group_peaks_by_node
    from sleap_nn_tpu_torch.ops.peaks import find_local_peaks

    post, scorer = layer.post, layer.paf_scorer
    images = torch.from_numpy(frames).to(DEVICE)
    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            x, eff = timed("preprocess", lambda: preprocess_images(layer.pre, images))
            preds = timed("unet", lambda: layer.backend(x))
            pts, vals, chans, valid = timed("local_peaks", lambda: find_local_peaks(
                preds[layer.cm_head], threshold=post.peak_threshold, refinement=post.refinement,
                integral_patch_size=post.integral_patch_size, max_peaks=post.max_peaks))
            gp, gv, mask = timed("group_by_node", lambda: group_peaks_by_node(
                pts * layer.cm_output_stride, vals, chans, valid, scorer.n_nodes,
                scorer.k_per_node))
            scores = timed("paf_scoring", lambda: scorer.score_lines(
                preds[layer.paf_head], gp, mask))
            dev = {"grouped_peaks": gp, "grouped_vals": gv, "scores": scores, "eff_scale": eff}
            timed("host_grouping", lambda: layer.postprocess_host(to_host(dev)))
    return times


def run_bottomup_end_to_end(layer, kernels):
    """Predict over the smoke frames with the grouping inline, then in 2 workers."""
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import VideoProvider

    frames = smoke_frames()
    n_nodes = layer.paf_scorer.n_nodes
    Predictor(layer, "bottomup", batch_size=BATCH, device=DEVICE).predict(
        provider=VideoProvider(ArrayVideo(frames[:BATCH]), batch_size=BATCH),
        make_labels=False)  # warm-up: allocator, cuDNN
    sync()
    runs, stats = {}, {}
    for workers in (0, 2):
        predictor = Predictor(layer, "bottomup", batch_size=BATCH, device=DEVICE,
                              paf_workers=workers)
        for k in kernels.values():
            k.launches = 0
        results = predictor.predict(provider=VideoProvider(ArrayVideo(frames), batch_size=BATCH),
                                    make_labels=False)
        launches = {name: k.launches for name, k in kernels.items()}
        n_batches = len(results)
        want = {"fused_double_conv3x3": 9 * n_batches, "nms_scores": n_batches,
                "paf_line_scores": n_batches, "multi_confmaps": 0}
        if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
            raise AssertionError(f"paf_workers={workers}: launch counts {launches}, "
                                 f"expected {want}")
        runs[workers] = results
        stats[f"paf_workers_{workers}"] = dict(predictor.last_stats, launches=launches,
                                               instances=check_bottomup_outputs(results, n_nodes))
    assert_same_outputs(runs[0], runs[2])
    stats["launches"] = stats["paf_workers_0"]["launches"]
    stats["instances"] = stats["paf_workers_0"]["instances"]
    stats["fps"] = stats["paf_workers_0"]["fps"]
    stats["n_frames"] = stats["paf_workers_0"]["n_frames"]
    stats["n_batches"] = len(runs[0])
    stats["instances_per_frame"] = [len(kp) for out in runs[0]
                                    for kp, v in zip(out["pred_keypoints"], out["valid"]) if v]
    stats["stage_ms"] = bottomup_stage_times(layer, frames[:BATCH])
    log("bottomup_end_to_end " + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# Phase 6: card against CPU on a small input
# --------------------------------------------------------------------------


def check_against_cpu():
    import torch

    from sleap_nn_tpu_torch.config.model_config import UNetConfig
    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.ops.peaks import find_global_peaks, find_local_peaks

    cfg, cm, im = build_models(UNetConfig, 5, seed=1, filters=8, max_stride=16)
    frames = np.random.default_rng(1).integers(0, 256, (2, 128, 128, 1), dtype=np.uint8)
    gpu = build_layer(cfg, cm, im, DEVICE, False, 32, 3)
    cpu = build_layer(cfg, cm, im, "cpu", False, 32, 3)
    report = {}
    with torch.inference_mode():
        for name, (g, c) in {"centroid": (gpu.centroid_layer, cpu.centroid_layer),
                             "instance": (gpu.instance_layer, cpu.instance_layer)}.items():
            x, _ = preprocess_images(c.pre, torch.from_numpy(frames))
            cms_g = g.backend(x.to(DEVICE))[g.head_name]
            cms_c = c.backend(x)[c.head_name]
            err = (cms_g.cpu() - cms_c).abs().max().item()
            report[f"{name}_maps_max_abs_err"] = err
            if err > 1e-4:
                raise AssertionError(f"{name} maps: card vs CPU max abs err {err}")
            if name == "centroid":
                got = find_local_peaks(cms_g, refinement="integral", max_peaks=8)
                want = find_local_peaks(cms_g.cpu(), refinement="integral", max_peaks=8)
            else:
                got = find_global_peaks(cms_g, refinement="integral")
                want = find_global_peaks(cms_g.cpu(), refinement="integral")
            for a, b in zip(got, want):
                a = a.cpu()
                if a.dtype.is_floating_point:
                    torch.testing.assert_close(a, b, rtol=0, atol=1e-5, equal_nan=True)
                else:
                    assert torch.equal(a, b)
    log("card_vs_cpu " + json.dumps(report))
    return report


def check_bottomup_against_cpu():
    """A narrow f32 bottom-up model on the card and on the CPU: maps to 1e-4;
    each later stage fed the card's inputs: peaks and scores to 1e-5 (-inf
    and NaN placement exact), grouped peaks and instances exactly."""
    import torch

    from sleap_nn_tpu_torch.config.model_config import UNetConfig
    from sleap_nn_tpu_torch.inference.layers import preprocess_images, to_host
    from sleap_nn_tpu_torch.inference.paf_grouping import group_peaks_by_node
    from sleap_nn_tpu_torch.ops.peaks import find_local_peaks

    frames = np.random.default_rng(2).integers(0, 256, (2, 128, 128, 1), dtype=np.uint8)
    cfg, model = build_bottomup_model(UNetConfig, 5, seed=2, frames=frames, filters=8,
                                      max_stride=16)
    gpu = build_bottomup_layer(cfg, model, DEVICE, False, 3)
    cpu = build_bottomup_layer(cfg, model, "cpu", False, 3)
    post, scorer = cpu.post, cpu.paf_scorer
    report = {}

    def close(name, a, b):
        a, b = a.cpu(), b.cpu()
        assert a.shape == b.shape and a.dtype == b.dtype, name
        if not a.dtype.is_floating_point:
            assert torch.equal(a, b), name
            return
        assert torch.equal(torch.isnan(a), torch.isnan(b)), name
        assert torch.equal(torch.isneginf(a), torch.isneginf(b)), name
        fin = torch.isfinite(b)
        err = (a[fin] - b[fin]).abs().max().item() if fin.any() else 0.0
        report[f"{name}_max_abs_err"] = err
        assert err <= 1e-5, (name, err)

    with torch.inference_mode():
        x, _ = preprocess_images(cpu.pre, torch.from_numpy(frames))
        preds_g, preds_c = gpu.backend(x.to(DEVICE)), cpu.backend(x)
        for head in (cpu.cm_head, cpu.paf_head):
            err = (preds_g[head].cpu() - preds_c[head]).abs().max().item()
            report[f"{head}_max_abs_err"] = err
            if err > 1e-4:
                raise AssertionError(f"{head}: card vs CPU max abs err {err}")
        cms, pafs = preds_g[cpu.cm_head], preds_g[cpu.paf_head]
        kw = dict(threshold=post.peak_threshold, refinement=post.refinement,
                  integral_patch_size=post.integral_patch_size, max_peaks=post.max_peaks)
        peaks_g = find_local_peaks(cms, **kw)
        for name, a, b in zip(("points", "vals", "channels", "valid"), peaks_g,
                              find_local_peaks(cms.cpu(), **kw)):
            close(f"peaks_{name}", a, b)
        pts, vals, chans, valid = peaks_g
        grouped_g = group_peaks_by_node(pts * 2, vals, chans, valid, scorer.n_nodes,
                                        scorer.k_per_node)
        grouped_c = group_peaks_by_node(*(a.cpu() for a in (pts * 2, vals, chans, valid)),
                                        scorer.n_nodes, scorer.k_per_node)
        for name, a, b in zip(("peaks", "vals", "mask"), grouped_g, grouped_c):
            assert torch.equal(a.cpu().nan_to_num(-1.0), b.nan_to_num(-1.0)), f"grouped_{name}"
        _, _, _, scores_g = gpu.paf_scorer.score_on_device(pafs, pts * 2, vals, chans, valid)
        _, _, _, scores_c = scorer.score_on_device(
            *(a.cpu() for a in (pafs, pts * 2, vals, chans, valid)))
        close("paf_scores", scores_g, scores_c)
        report["finite_scores"] = int(torch.isfinite(scores_c).sum())
        assert report["finite_scores"] > 0, "no pair to score: the check would hold nothing"
        inst = [layer.postprocess_host(to_host(
                    {"grouped_peaks": grouped_c[0], "grouped_vals": grouped_c[1],
                     "scores": s, "eff_scale": 1.0}))
                for layer, s in ((gpu, scores_g), (cpu, scores_c))]
    for key in ("pred_keypoints", "pred_peak_values"):
        for a, b in zip(inst[0][key], inst[1][key]):
            assert np.array_equal(a, b, equal_nan=True), key
    for a, b in zip(inst[0]["pred_instance_scores"], inst[1]["pred_instance_scores"]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    report["instances"] = [len(kp) for kp in inst[1]["pred_keypoints"]]
    log("bottomup_card_vs_cpu " + json.dumps(report))
    return report


# --------------------------------------------------------------------------
# Phases 7, 10 and 11: training end to end
# --------------------------------------------------------------------------


def training_labels(n_frames, img, n_nodes, max_inst, seed):
    """Labels of ``n_frames`` synthetic uint8 frames, 1..max_inst instances of
    ``n_nodes`` nodes each (about 10% of the nodes missing), from a seed."""
    from sleap_nn_tpu_torch.io.model import Instance, LabeledFrame, Labels, Skeleton

    rng = np.random.default_rng(seed)
    video = ArrayVideo(rng.integers(0, 256, (n_frames, img, img, 1), dtype=np.uint8))
    names = [f"n{i}" for i in range(n_nodes)]
    skel = Skeleton(names, edges=bottomup_edges(n_nodes))
    frames = []
    for f in range(n_frames):
        insts = []
        for _ in range(int(rng.integers(1, max_inst + 1))):
            center = rng.uniform(0.1 * img, 0.9 * img, 2)
            pts = center + rng.normal(0, 0.03 * img, (n_nodes, 2))
            pts[rng.random(n_nodes) < 0.1] = np.nan
            insts.append(Instance(pts, skel))
        frames.append(LabeledFrame(video, f, insts))
    return Labels(frames)


TRAIN_HEADS = {
    "centroid": {"confmaps": {"sigma": 5.0, "output_stride": 2}},
    "single_instance": {"confmaps": {"sigma": 2.5, "output_stride": 2}},
    "centered_instance": {"confmaps": {"sigma": 2.5, "output_stride": 2}},
    "bottomup": {"confmaps": {"sigma": 2.5, "output_stride": 2},
                 "pafs": {"sigma": 15.0, "output_stride": 4}},
    "multi_class_bottomup": {"confmaps": {"sigma": 2.5, "output_stride": 2},
                             "class_maps": {"sigma": 5.0, "output_stride": 2}},
    "multi_class_topdown": {"confmaps": {"sigma": 2.5, "output_stride": 2},
                            "class_vectors": {"num_fc_layers": 1, "num_fc_units": 64,
                                              "global_pool": True}},
}


def with_tracks(labels, n_classes, seed):
    """``labels`` with each instance given one of ``n_classes`` tracks
    (``id0``, ``id1``, ...), distinct within its frame, from a seed of its
    own (the labels' points are untouched)."""
    from sleap_nn_tpu_torch.io.model import Track

    rng = np.random.default_rng(seed)
    tracks = [Track(name=f"id{c}") for c in range(n_classes)]
    for lf in labels.labeled_frames:
        for inst, c in zip(lf.instances, rng.permutation(n_classes)):
            inst.track = tracks[c]
    labels.tracks = tracks
    return labels


def training_config(filters, max_stride, img, batch, augment, model_type="centroid",
                    crop_size=None, **trainer):
    """A training config: UNet (filters_rate 1.5, output stride 2), the
    model type's heads of ``TRAIN_HEADS`` (confmaps at stride 2; PAFs sigma
    15 at stride 4, edges from the skeleton), Adam lr 1e-4, f32."""
    from sleap_nn_tpu_torch.config import TrainingJobConfig

    return TrainingJobConfig.from_dict({
        "data_config": {
            "use_augmentations_train": augment,
            "augmentation_config": {"geometric": {}} if augment else None,
            "preprocessing": {"max_height": img, "max_width": img, "crop_size": crop_size},
        },
        "model_config": {
            "backbone_config": {"unet": {"filters": filters, "filters_rate": 1.5,
                                         "max_stride": max_stride, "output_stride": 2}},
            "head_configs": {model_type: TRAIN_HEADS[model_type]},
        },
        "trainer_config": {
            "optimizer_name": "Adam", "optimizer": {"lr": 1e-4}, "seed": 0,
            "train_data_loader": {"batch_size": batch}, "val_data_loader": {"batch_size": batch},
            **trainer,
        },
    })


def train_stage_times(trainer, batch):
    """ms of one train step by stage, each fenced by synchronize(). For a
    bottom-up model also the render's parts (``render_parts``: preprocess
    with augmentation, the confmaps through kernel 4, the PAFs, and the
    PAF render's own peak device memory), with kernel 4 held against its
    plain version on the path's own points; for a multi-class bottom-up
    model the class maps and their render's peak memory in place of the
    PAFs."""
    import torch

    from sleap_nn_tpu_torch.data.identity import generate_class_maps
    from sleap_nn_tpu_torch.data.pipeline import preprocess_batch
    from sleap_nn_tpu_torch.data.resizing import apply_pad_to_stride
    from sleap_nn_tpu_torch.ops.confmaps import generate_multiconfmaps
    from sleap_nn_tpu_torch.ops.edge_maps import generate_pafs
    from sleap_nn_tpu_torch.ops.grid import make_grid_vectors
    from sleap_nn_tpu_torch.ops.kernels import _plain_multi_confmaps
    from sleap_nn_tpu_torch.training.losses import compute_loss
    from sleap_nn_tpu_torch.training.model_trainer import sample_weights

    times = {}

    def timed(name, fn, into=times):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        into[name] = (time.perf_counter() - t0) * 1e3
        return out

    trainer.model.train()
    for _ in range(2):  # the second pass is the one kept
        processed = timed("render", lambda: trainer.render(batch, train=True))
        trainer.optimizer.zero_grad(set_to_none=True)
        preds = timed("forward", lambda: trainer.model(processed["image"]))
        loss = timed("loss", lambda: compute_loss(
            preds, processed, trainer.model.heads, sample_weights(processed, True),
            trainer._ohkm)[0])
        timed("backward", loss.backward)
        timed("optimizer", trainer.optimizer.step)
    times["sum"] = sum(times.values())
    if trainer.model_type not in ("bottomup", "multi_class_bottomup"):
        return times

    ctx, parts = trainer.ctx, {}
    dbatch = trainer._to_device(batch)
    edges = torch.tensor(ctx.edge_inds, dtype=torch.long, device=trainer.device)
    with torch.no_grad():
        for _ in range(2):  # the second pass is the one kept
            image, inst, _eff = timed("preprocess", lambda: preprocess_batch(
                ctx, dbatch["image"], dbatch["instances"], trainer.generator, True), parts)
            hw = tuple(apply_pad_to_stride(image, ctx.max_stride).shape[1:3])
            cms = timed("confmaps_kernel4", lambda: generate_multiconfmaps(
                inst, hw, sigma=ctx.sigma, output_stride=ctx.output_stride), parts)
            if DEVICE != "cpu":
                torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated() if DEVICE != "cpu" else 0
            if trainer.model_type == "bottomup":
                name = "pafs"
                second = timed(name, lambda: generate_pafs(
                    inst, hw, edges, sigma=ctx.pafs_sigma,
                    output_stride=ctx.pafs_output_stride), parts)
            else:
                name = "class_maps"
                second = timed(name, lambda: generate_class_maps(
                    inst, hw, dbatch["track_ids"], ctx.n_classes, sigma=ctx.class_maps_sigma,
                    output_stride=ctx.class_maps_output_stride), parts)
            if DEVICE != "cpu":
                parts[f"{name}_peak_mib"] = (torch.cuda.max_memory_allocated() - base) / 2**20
        xv, yv = make_grid_vectors(*hw, ctx.output_stride, device=inst.device)
        want = _plain_multi_confmaps(inst, xv, yv, ctx.sigma * ctx.output_stride)
    parts["confmaps_max_abs_err"] = (cms - want).abs().max().item()
    if not parts["confmaps_max_abs_err"] <= 1e-6:
        raise AssertionError(f"kernel 4 on the bottom-up training path: {parts}")
    parts["points"], parts["confmaps"], parts[f"{name}_shape"] = (
        list(inst.shape), list(cms.shape), list(second.shape))
    times["render_parts"] = parts
    return times


MODEL_DIR_FILES = {"initial_config.yaml", "training_config.yaml", "best.ckpt", "training_log.csv"}

# The epoch-end evaluation of phases 7 and 11. The models train 5-10 steps
# from Xavier init, so their maps sit near 0 and their peaks lie anywhere:
# every local maximum counts as a peak (as in phase 13), and a centroid
# peak matches a ground-truth centroid at any distance, so that the
# evaluation always has pairs to score. It checks the path, not accuracy.
EVAL_PEAK_THRESHOLD, EVAL_MATCH_THRESHOLD = -1e9, 1e4
EVAL_KEYS = {"centroid": {"val/dist.avg", "val/detection.f1"},
             "centered_instance": {"val/mOKS", "val/dist.avg"},
             "multi_class_topdown": {"val/mOKS", "val/dist.avg"}}


def check_eval_peaks(cms):
    """Phase 7: the epoch-end evaluation's centroid peaks
    (``find_local_peaks(..., "integral", max_peaks=20)``) on one val batch's
    f32 maps, through kernel 2 and through its plain version: equal
    exactly (points, values, channels and validity)."""
    import torch

    from sleap_nn_tpu_torch.ops import kernels, peaks

    assert cms.dtype == torch.float32, cms.dtype
    got = peaks.find_local_peaks(cms, EVAL_PEAK_THRESHOLD, "integral", max_peaks=20)
    real = peaks.nms_scores
    peaks.nms_scores = kernels._plain_nms_scores
    try:
        want = peaks.find_local_peaks(cms, EVAL_PEAK_THRESHOLD, "integral", max_peaks=20)
    finally:
        peaks.nms_scores = real
    for g, w in zip(got, want):
        same_nan = torch.equal(torch.isnan(g), torch.isnan(w)) if g.is_floating_point() else True
        if not (same_nan and torch.equal(torch.nan_to_num(g), torch.nan_to_num(w))):
            raise AssertionError("epoch-end eval peaks: kernel 2 and its plain version differ")
    return {"maps": list(cms.shape), "dtype": "float32", "peaks": int(got[3].sum()),
            "equal_to_plain": True}


def run_training_end_to_end(kernels, root, model_type="centroid", crop_size=None,
                            evaluate=False):
    """Phases 7, 10, 11, 17 and 18: ``ModelTrainer.train`` of a medium_rf
    model of ``model_type`` on the synthetic labels (with ``N_CLASSES``
    tracks for an identity model), into the model dir
    ``root/<model_type>`` (which phases 13 and 19 predict from). Kernel 4
    renders the centroid and (multi-class) bottom-up confmaps, once per
    train step, val batch and setup probe; the crop models launch no
    kernel. With
    ``evaluate``, the epoch-end evaluation runs every epoch (``eval.enabled``,
    ``frequency`` 1, peaks and matching as ``EVAL_PEAK_THRESHOLD`` and
    ``EVAL_MATCH_THRESHOLD`` say): for a
    centroid model it renders each val batch again (kernel 4) and finds its
    peaks (kernel 2, on f32 maps); its ``val/*`` keys must be in every
    epoch's logs, and its seconds per epoch are printed."""
    import torch

    from sleap_nn_tpu_torch.models.model import Model
    from sleap_nn_tpu_torch.training import ModelTrainer
    from sleap_nn_tpu_torch.training.callbacks import EpochEndEvaluationCallback

    labels = training_labels(TRAIN_FRAMES + VAL_FRAMES, TRAIN_IMG, N_NODES, MAX_INST, seed=4)
    if model_type.startswith("multi_class"):
        labels = with_tracks(labels, N_CLASSES, seed=17)
    train = labels.extract(range(TRAIN_FRAMES))
    val = labels.extract(range(TRAIN_FRAMES, TRAIN_FRAMES + VAL_FRAMES))
    cfg = training_config(24, 32, TRAIN_IMG, TRAIN_BATCH, augment=True, model_type=model_type,
                          crop_size=crop_size, max_epochs=TRAIN_EPOCHS,
                          train_steps_per_epoch=TRAIN_STEPS, save_ckpt=True,
                          ckpt_dir=str(root), run_name=model_type,
                          model_ckpt={"save_last": True},
                          eval={"enabled": evaluate, "frequency": 1,
                                "match_threshold": EVAL_MATCH_THRESHOLD})
    trainer = ModelTrainer.get_model_trainer_from_config(cfg, [train], [val], device=DEVICE)
    if DEVICE != "cpu":
        torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    trainer.setup()
    eval_s = []
    if evaluate:
        eval_cb = next(cb for cb in trainer.callbacks
                       if isinstance(cb, EpochEndEvaluationCallback))
        eval_cb.peak_threshold = EVAL_PEAK_THRESHOLD
        inner = eval_cb._evaluate

        def timed_evaluate(tr):
            sync()
            t0 = time.perf_counter()
            out = inner(tr)
            sync()
            eval_s.append(time.perf_counter() - t0)
            return out

        eval_cb._evaluate = timed_evaluate
    start = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    history = trainer.train()
    sync()
    launches = {name: k.launches for name, k in kernels.items()}
    n_val = len(trainer.val_loader)
    n_renders = TRAIN_EPOCHS * (TRAIN_STEPS + n_val) + 1
    eval_renders = TRAIN_EPOCHS * n_val if evaluate else 0
    centroid_eval = eval_renders if model_type == "centroid" else 0
    want = {"fused_double_conv3x3": 0, "nms_scores": centroid_eval, "paf_line_scores": 0,
            "multi_confmaps": n_renders + centroid_eval
            if model_type in ("centroid", "bottomup", "multi_class_bottomup") else 0}
    if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
        raise AssertionError(f"{model_type} training launch counts {launches}, "
                             f"expected {want}")
    peak_mem_gib = torch.cuda.max_memory_allocated() / 2**30 if DEVICE != "cpu" else None
    losses = [h[k] for h in history for k in ("train/loss", "val/loss")]
    assert len(history) == TRAIN_EPOCHS and np.isfinite(losses).all(), history
    if evaluate:
        keys = EVAL_KEYS[model_type]
        missing = [sorted(keys - set(h)) for h in history]
        if any(missing) or len(eval_s) != TRAIN_EPOCHS:
            raise AssertionError(f"{model_type} epoch-end evaluation: keys missing {missing}, "
                                 f"{len(eval_s)} evaluations in {TRAIN_EPOCHS} epochs")
        log(f"epoch_end_eval {model_type}: " + json.dumps({
            "seconds_per_epoch": eval_s, "val_batches": n_val,
            "logs": [{k: h[k] for k in sorted(keys)} for h in history]}))
    if model_type == "multi_class_topdown":
        accuracy = [{k: h.get(k) for k in ("train/class_accuracy", "val/class_accuracy")}
                    for h in history]
        if any(v is None for a in accuracy for v in a.values()):
            raise AssertionError(f"{model_type}: class_accuracy missing from the logs {accuracy}")
        log(f"class_accuracy {model_type}: " + json.dumps(accuracy))
    moved = {k: (v - start[k]).abs().max().item()
             for k, v in trainer.model.state_dict().items()}
    assert all(d > 0 for d in moved.values()), moved
    # best.ckpt loads strictly; last.ckpt gives the trainer's outputs exactly.
    ckpts = {}
    for name in ("best.ckpt", "last.ckpt"):
        fresh = Model.from_config("unet", cfg.model_config.backbone_config.unet,
                                  getattr(cfg.model_config.head_configs, model_type),
                                  model_type)
        fresh.load_state_dict(ModelTrainer.load_checkpoint_params(
            trainer.ckpt_dir / name), strict=True)
        ckpts[name] = fresh.to(DEVICE).eval()
    vbatch = next(iter(trainer.val_loader))
    trainer.model.eval()
    with torch.no_grad():
        x = trainer.render(vbatch, train=False)["image"]
        ours, theirs = trainer.model(x), ckpts["last.ckpt"](x)
    if not all(torch.equal(ours[k], theirs[k]) for k in ours):
        raise AssertionError(f"{model_type}: last.ckpt does not reproduce the trainer's outputs")
    eval_peaks = (check_eval_peaks(ours["CentroidConfmapsHead"])
                  if evaluate and model_type == "centroid" else None)
    best = torch.load(trainer.ckpt_dir / "best.ckpt", weights_only=True)
    assert best["best_val_loss"] == min(h["val/loss"] for h in history), best["best_val_loss"]
    files = {p.name for p in trainer.ckpt_dir.iterdir()}
    if not MODEL_DIR_FILES <= files:
        raise AssertionError(f"{model_type}: the model dir holds {sorted(files)}")

    batch = next(iter(trainer.train_loader))
    stages = train_stage_times(trainer, batch)
    # A steady window beside the trainer's own 5-step epochs: 20 steps on
    # one host batch (render included, no loader), fenced by synchronize().
    sync()
    t0 = time.perf_counter()
    fixed = [trainer.train_step(batch)[0] for _ in range(20)]
    sync()
    fixed_s = time.perf_counter() - t0
    fixed = [v.item() for v in fixed]
    if not fixed[-1] < fixed[0]:
        raise AssertionError(f"{model_type}: 20 steps on one batch did not lower the loss: {fixed}")
    stats = {
        "model_type": model_type, "launches": launches, "n_batches": n_renders,
        "history": history, "steps_per_sec": history[-1]["train/steps_per_sec"],
        "samples_per_sec": history[-1]["train/samples_per_sec"],
        "steps_per_sec_by_epoch": [h["train/steps_per_sec"] for h in history],
        "fixed_batch_steps_per_sec": 20 / fixed_s,
        "fixed_batch_samples_per_sec": 20 * TRAIN_BATCH / fixed_s,
        "stage_ms": stages,
        "fixed_batch_loss_first_last": [fixed[0], fixed[-1]],
        "params": sum(v.numel() for v in start.values()), "input_shape": trainer._input_shape,
        "train_samples": len(trainer.train_ds), "val_batches": n_val,
        "peak_mem_gib": peak_mem_gib, "model_dir": str(trainer.ckpt_dir),
        "model_dir_files": sorted(files), "eval_seconds_per_epoch": eval_s,
        "eval_renders": eval_renders, "eval_peaks": eval_peaks,
    }
    log(("train_end_to_end " if model_type == "centroid" else f"train_{model_type}_end_to_end ")
        + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# Phases 8 and 12: training on the card against the CPU
# --------------------------------------------------------------------------


def check_training_against_cpu(model_type="centroid"):
    """Phases 8 and 12: a narrow f32 model of ``model_type`` trained 3 steps
    on the card and on the CPU from the same parameters and batch
    (augmentation off)."""
    import torch

    from sleap_nn_tpu_torch.training import ModelTrainer

    labels = training_labels(8, 128, 5, 1 if model_type == "single_instance" else 3, seed=5)
    cfg = lambda: training_config(8, 8, 128, 4, augment=False, model_type=model_type,  # noqa: E731
                                  crop_size=64 if model_type == "centered_instance" else None)
    train, val = labels.extract(range(6)), labels.extract(range(6, 8))
    card = ModelTrainer.get_model_trainer_from_config(cfg(), [train], [val], device=DEVICE)
    cpu = ModelTrainer.get_model_trainer_from_config(cfg(), [train], [val], device="cpu")
    card.setup()
    cpu.setup()
    card.model.load_state_dict(cpu.model.state_dict(), strict=True)
    batch = next(iter(cpu.train_loader))
    report = {"model_type": model_type}
    for step in range(3):
        loss_card, loss_cpu = card.train_step(batch)[0].item(), cpu.train_step(batch)[0].item()
        if step == 0:
            report["loss_rel_err"] = abs(loss_card - loss_cpu) / abs(loss_cpu)
            assert report["loss_rel_err"] <= 1e-5, report
            grads = {n: (p.grad.cpu(), cpu_p.grad) for (n, p), cpu_p in zip(
                card.model.named_parameters(), cpu.model.parameters())}
            report["grad_err_over_max"] = max(
                (a - b).abs().max().item() / b.abs().max().item() for a, b in grads.values())
            assert report["grad_err_over_max"] <= 1e-4, report
    report["param_max_abs_err"] = max(
        (a.cpu() - b).abs().max().item()
        for a, b in zip(card.model.state_dict().values(), cpu.model.state_dict().values()))
    assert report["param_max_abs_err"] <= 1e-5, report
    report["losses_step3"] = [loss_card, loss_cpu]
    log("train_card_vs_cpu " + json.dumps(report))
    return report


# --------------------------------------------------------------------------
# Phase 9: single-instance end to end
# --------------------------------------------------------------------------

SINGLE_KEYS = {"pred_keypoints", "pred_peak_values", "frame_inds", "video_inds", "valid"}


def build_single_instance_layer(cfg_cls, n_nodes, seed, device, use_bf16, **cfg_kw):
    """A single-instance model (confmaps at stride 2) with random weights from
    ``seed``, initialised as in :func:`build_models`, behind its layer."""
    import torch
    from types import SimpleNamespace as ns

    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.inference.layers import (
        PostprocessConfig, PreprocessConfig, SingleInstanceLayer)
    from sleap_nn_tpu_torch.models.model import Model

    cfg = cfg_cls(in_channels=1, output_stride=2, **cfg_kw)
    torch.manual_seed(seed)
    model = Model.from_config("unet", cfg, ns(confmaps=ns(
        part_names=[f"n{i}" for i in range(n_nodes)], sigma=2.5, output_stride=2,
        loss_weight=None)), "single_instance")
    random_init(model)
    return SingleInstanceLayer(
        TorchBackend(model, None, use_bf16=use_bf16, output_dtype=None, device=device),
        PreprocessConfig(ensure_grayscale=True, max_stride=cfg.max_stride),
        PostprocessConfig(peak_threshold=0.2), output_stride=2, device=device)


def single_instance_stage_times(layer, frames):
    """Per-stage ms of one single-instance batch, each stage fenced by synchronize()."""
    import torch

    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.ops.peaks import find_global_peaks

    images = torch.from_numpy(frames).to(DEVICE)
    times = {}

    def timed(name, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        times[name] = (time.perf_counter() - t0) * 1e3
        return out

    with torch.inference_mode():
        for _ in range(2):  # the second pass is the one kept
            x, _eff = timed("preprocess", lambda: preprocess_images(layer.pre, images))
            cms = timed("unet", lambda: layer.backend(x)[layer.head_name])
            timed("global_peaks", lambda: find_global_peaks(
                cms, threshold=layer.post.peak_threshold, refinement=layer.post.refinement,
                integral_patch_size=layer.post.integral_patch_size))
    times["sum"] = sum(times.values())
    return times


def run_single_instance_end_to_end(layer, kernels):
    """Phase 9: ``Predictor.predict`` of the single-instance model over the
    smoke frames: 9 fused-conv launches per batch and no other kernel; the
    JAX package's keys and shapes, every node found inside the frame."""
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import VideoProvider

    frames = smoke_frames()
    n_nodes = len(layer.backend.model.heads[0].part_names)
    predictor = Predictor(layer, "single_instance", batch_size=BATCH, device=DEVICE)
    predictor.predict(provider=VideoProvider(ArrayVideo(frames[:BATCH]), batch_size=BATCH),
                      make_labels=False)  # warm-up: allocator, cuDNN
    sync()
    for k in kernels.values():
        k.launches = 0
    results = predictor.predict(provider=VideoProvider(ArrayVideo(frames), batch_size=BATCH),
                                make_labels=False)
    launches = {name: k.launches for name, k in kernels.items()}
    n_batches = len(results)
    want = {"fused_double_conv3x3": 9 * n_batches, "nms_scores": 0, "paf_line_scores": 0,
            "multi_confmaps": 0}
    if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
        raise AssertionError(f"single-instance launch counts {launches}, expected {want}")
    assert n_batches == -(-N_FRAMES // BATCH), n_batches
    for i, out in enumerate(results):
        assert set(out) == SINGLE_KEYS, sorted(out)
        kp, vals = out["pred_keypoints"], out["pred_peak_values"]
        assert kp.shape == (BATCH, 1, n_nodes, 2) and kp.dtype == np.float32, kp.shape
        assert vals.shape == (BATCH, 1, n_nodes), vals.shape
        # Heads biased to 0.5 put every node above the threshold.
        assert np.isfinite(kp).all() and (vals >= 0.2).all()
        assert (np.abs(kp - IMG / 2) <= IMG / 2).all()
        n_valid = min(BATCH, N_FRAMES - i * BATCH)
        assert out["valid"].tolist() == [True] * n_valid + [False] * (BATCH - n_valid)
        assert out["frame_inds"][:n_valid].tolist() == list(range(i * BATCH, i * BATCH + n_valid))
    stats = dict(predictor.last_stats, launches=launches, n_batches=n_batches,
                 stage_ms=single_instance_stage_times(layer, frames[:BATCH]))
    log("single_instance_end_to_end " + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# Phase 13: predict from the model directories of phases 7, 10 and 11
# --------------------------------------------------------------------------

# The phase-13 models trained 10 steps from Xavier init: their maps sit near
# 0, so every local maximum counts as a peak (and, bottom-up, every scored
# line may link two peaks) for every frame to yield instances. Each
# bottom-up confmap channel keeps an offset of its own, so the top 200
# local maxima of a frame can all fall in channels that no edge joins:
# the bottom-up run keeps 2000, of which each node's best 20 are grouped.
DIR_PEAK_THRESHOLD, DIR_MIN_LINE, DIR_MAX_PEAKS = -1e9, -1e9, 2000


def frame_labels(frames):
    """In-memory ``Labels`` of empty frames over ``frames``: what
    ``run.predict`` predicts on."""
    from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels

    video = ArrayVideo(frames)
    return Labels([LabeledFrame(video, i) for i in range(len(frames))], videos=[video])


def instance_classes(out, i, model_type):
    """Row ``i``'s class index of each of its instances (as ``to_labels``
    keeps them), or None for a model without classes."""
    if model_type == "multi_class_topdown":
        return out["pred_class_inds"][i][out["instance_valid"][i]]
    if model_type == "multi_class_bottomup":  # one row per class
        return np.arange(out["pred_keypoints"].shape[1])
    return None


def labels_hold_outputs(labels, results, model_type, class_names=None):
    """The ``Labels`` of a run hold exactly the instances of the raw batch
    outputs (the non-NaN, valid ones), frame by frame, and for an identity
    model each with the ``Track`` named after its class (``class_names``),
    no track twice in a frame; returns their count."""
    want = {}
    for out in results:
        for i in np.flatnonzero(out["valid"]):
            if model_type in ("topdown", "multi_class_topdown"):
                keep = out["instance_valid"][i]
                pts, vals = out["pred_keypoints"][i][keep], out["pred_peak_values"][i][keep]
            else:
                pts, vals = out["pred_keypoints"][i], out["pred_peak_values"][i]
            found = ~np.isnan(pts).all(axis=(1, 2))
            classes = instance_classes(out, i, model_type)
            names = None if classes is None else [
                class_names[c] if c >= 0 else None for c in classes[found]]
            if found.any():
                want[int(out["frame_inds"][i])] = (pts[found], vals[found], names)
    got = {lf.frame_idx: lf for lf in labels.labeled_frames}
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    for idx, (pts, vals, names) in want.items():
        insts = got[idx].instances
        assert np.array_equal(np.stack([x.points for x in insts]), pts.astype(np.float64),
                              equal_nan=True), idx
        assert np.array_equal(np.stack([x.point_scores for x in insts]),
                              np.nan_to_num(vals.astype(np.float64))), idx
        if names is not None:
            tracks = [x.track.name if x.track is not None else None for x in insts]
            if tracks != names or len(set(tracks) - {None}) != len(tracks) - tracks.count(None):
                raise AssertionError(f"frame {idx}: tracks {tracks}, classes {names}")
    return sum(len(lf) for lf in labels.labeled_frames)


# Launches per predict batch of each path: fused conv, NMS, PAF line scores.
PREDICT_LAUNCHES = {"topdown": (18, 1, 0), "bottomup": (9, 1, 1),
                    "multi_class_topdown": (18, 1, 0), "multi_class_bottomup": (9, 1, 0)}


def run_model_dir_predict(kernels, dirs, model_type):
    """Phases 13 and 19: ``run.predict`` over in-memory Labels of the smoke
    frames from trained model dirs (bf16, batch 8, no output file), the
    counted run; then one ``Predictor.from_model_paths`` predicts the same
    frames to raw outputs and to ``Labels``, which must hold the same
    instances (an identity model's with the tracks of their classes)."""
    import torch

    from sleap_nn_tpu_torch.inference.loaders import load_model
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.run import predict

    for d in dirs:  # the loader's weights are the checkpoint file's, bit for bit
        loaded = load_model(d).model.state_dict()
        saved = torch.load(d / "best.ckpt", map_location="cpu", weights_only=True)["state_dict"]
        best = {k.removeprefix("model."): v for k, v in saved.items()}
        assert set(loaded) == set(best) and len(best) == len(saved)
        if not all(torch.equal(loaded[k].cpu(), best[k]) for k in best):
            raise AssertionError(f"{d}: loaded weights differ from best.ckpt")
    frames = smoke_frames()
    kw = dict(batch_size=BATCH, use_bf16=True, device=DEVICE, peak_threshold=DIR_PEAK_THRESHOLD,
              max_instances=MAX_INST)
    if model_type == "bottomup":
        kw.update(min_line_scores=DIR_MIN_LINE, max_peaks=DIR_MAX_PEAKS, paf_workers=0)
    predict(frame_labels(frames[:BATCH]), dirs, make_labels=False, **kw)  # warm-up
    sync()
    for k in kernels.values():
        k.launches = 0
    labels = predict(frame_labels(frames), dirs, output_path=None, **kw)
    sync()
    launches = {name: k.launches for name, k in kernels.items()}
    n_batches = -(-N_FRAMES // BATCH)
    per_batch = PREDICT_LAUNCHES[model_type]
    want = dict(zip(("fused_double_conv3x3", "nms_scores", "paf_line_scores"),
                    (n * n_batches for n in per_batch)), multi_confmaps=0)
    if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
        raise AssertionError(f"{model_type} from dirs: launch counts {launches}, "
                             f"expected {want}")
    predictor = Predictor.from_model_paths(dirs, **kw)
    results = predictor.predict(frame_labels(frames), make_labels=False)
    same_labels = predictor.predict(frame_labels(frames), make_labels=True)
    names = predictor.class_names
    n_inst = labels_hold_outputs(same_labels, results, model_type, names)
    if labels_hold_outputs(labels, results, model_type, names) != n_inst:
        raise AssertionError(f"{model_type} from dirs: run.predict's Labels differ")
    per_frame = [len(lf) for lf in labels.labeled_frames]
    if len(labels.labeled_frames) != N_FRAMES:
        raise AssertionError(f"{model_type} from dirs: instances on "
                             f"{len(labels.labeled_frames)} of {N_FRAMES} frames: {per_frame}")
    stats = dict(labels.provenance["stats"], launches=launches, n_batches=n_batches,
                 instances=n_inst, instances_per_frame=per_frame,
                 peak_threshold=DIR_PEAK_THRESHOLD, backend=labels.provenance["backend"],
                 model_dirs=[str(d) for d in dirs])
    if names is not None:
        stats["tracks"] = [t.name for t in labels.tracks]
        stats["tracked_instances"] = sum(i.track is not None for lf in labels for i in lf)
    log(f"model_dir_{model_type}_predict " + json.dumps(stats))
    return stats


# --------------------------------------------------------------------------
# Phase 14: narrow model dirs trained on the CPU, predicted on the card and the CPU
# --------------------------------------------------------------------------


def blob_labels(n, img, n_nodes, max_inst, seed):
    """Black uint8 frames with bright Gaussian blobs, and labels of 1..max_inst
    instances of ``n_nodes`` nodes around them."""
    from sleap_nn_tpu_torch.io.model import Instance, LabeledFrame, Labels, Skeleton

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:img, :img]
    frames = np.zeros((n, img, img, 1), np.float32)
    centers = [rng.uniform(0.2 * img, 0.8 * img, (int(rng.integers(1, max_inst + 1)), 2))
               for _ in range(n)]
    for f, xy in enumerate(centers):
        for cx, cy in xy:
            frames[f, ..., 0] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 4.0 ** 2))
    video = ArrayVideo((np.clip(frames, 0, 1) * 255).astype(np.uint8))
    skel = Skeleton([f"n{i}" for i in range(n_nodes)], edges=bottomup_edges(n_nodes))
    return Labels([LabeledFrame(video, f, [Instance(c + rng.normal(0, 4, (n_nodes, 2)), skel)
                                           for c in xy]) for f, xy in enumerate(centers)])


def condition_weights(model, frames):
    """Zero every bias and move each confmap head channel onto [0, 1] over
    the frames, as the CPU tests of the model dirs condition a bottom-up or
    orbax-loaded head. Away from the blobs every feature is then exactly 0
    on either device, so no float-noise tie between the card and the CPU
    decides a peak, and every refinement patch holds positive mass. As
    trained, the top-down maps reach no peak above 0.2; with every local
    maximum counted, patches whose mass nearly cancels (|mass| down to
    1.4% of the absolute mass) move refined points by up to 0.0076 px
    between f32 and f64 on the CPU alone, past this phase's 1e-4 px bound
    (``tools/model_dir_divergence.py``; PERF.md, PR 7)."""
    import torch

    heads = {"CentroidConfmapsHead", "CenteredInstanceConfmapsHead", "MultiInstanceConfmapsHead"}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
        model.eval()
        out = model(torch.from_numpy(frames / np.float32(255.0)))
        for layer in model.head_layers:
            for head, conv in ((h, m[0]) for h, m in layer.items() if h in heads):
                maps = out[head].numpy()
                top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
                conv.weight.div_(torch.from_numpy(top - bottom)[:, None, None, None])
                conv.bias.copy_(torch.from_numpy(-bottom / (top - bottom)))


# Phase 14's runs: name, the model types of its dirs, run.predict's knobs.
# Top-down keeps every centroid above 0.5 (max_instances 64, above any
# frame's count), so no near-tie at the cut decides which instances a
# frame holds.
NARROW_RUNS = (("topdown", ("centroid", "centered_instance"),
                {"max_instances": 64, "peak_threshold": 0.5}),
               ("bottomup", ("bottomup",), {"min_line_scores": -0.5}))


def train_narrow_dirs(root, condition=True):
    """Phase 14's labels and its narrow (filters 8, 128x128) centroid,
    centered-instance and bottom-up dirs, each trained 3 steps on the CPU
    under ``root/narrow``; with ``condition``, the weights are then
    conditioned (``condition_weights``) and saved by the trainer."""
    from sleap_nn_tpu_torch.training import ModelTrainer

    labels = blob_labels(10, 128, 5, 3, seed=14)
    dirs = {}
    for model_type in ("centroid", "centered_instance", "bottomup"):
        cfg = training_config(8, 16, 128, 4, augment=False, model_type=model_type,
                              crop_size=64 if model_type == "centered_instance" else None,
                              max_epochs=1, train_steps_per_epoch=3, save_ckpt=True,
                              ckpt_dir=str(root / "narrow"), run_name=model_type)
        trainer = ModelTrainer.get_model_trainer_from_config(
            cfg, [labels.extract(range(8))], [labels.extract(range(8, 10))], device="cpu")
        trainer.train()
        if condition:
            condition_weights(trainer.model, labels.video.frames)
            trainer.save_checkpoint("best.ckpt")
        dirs[model_type] = trainer.ckpt_dir
    return labels, dirs


def check_model_dirs_against_cpu(labels, dirs):
    """Phase 14: the narrow dirs of ``train_narrow_dirs`` (its ``labels`` and
    ``dirs``), conditioned, predicted through ``run.predict`` on the card and
    on the CPU in f32. Counts, validity and NaN placement exact; each
    frame's instances, in canonical order, with keypoints to 1e-4 px and
    peak values and instance scores to 1e-5. ``tools/model_dir_divergence.py``
    shows why the weights are conditioned (PERF.md, PR 7)."""
    from sleap_nn_tpu_torch.inference.run import predict

    frames = labels.video.frames
    report = {}
    for name, types, kw in NARROW_RUNS:
        paths = [dirs[t] for t in types]
        runs = [predict(frame_labels(frames), paths, batch_size=4, make_labels=False,
                        device=device, **kw) for device in (DEVICE, "cpu")]
        report[name] = compare_outputs(*runs)
        report[name]["most_in_a_frame"] = max(
            len(frame_instances(out, i)[0]) for out in runs[1] for i in np.flatnonzero(out["valid"]))
        if report[name]["instances"] < len(frames) or report[name]["most_in_a_frame"] >= 64:
            raise AssertionError(f"phase 14 {name}: too few instances {report[name]}")
    log("model_dirs_card_vs_cpu " + json.dumps(report))
    return report


def frame_instances(out, i):
    """Row ``i`` of a batch output as per-instance arrays, in a canonical
    order (by keypoint position): near-equal peak values may rank two
    instances either way on two devices."""
    if "instance_valid" in out:  # top-down
        keep = out["instance_valid"][i]
        arrays = [out[k][i][keep] for k in ("pred_keypoints", "pred_peak_values",
                                            "pred_centroids", "centroid_vals")]
    else:
        arrays = [np.asarray(out[k][i]) for k in ("pred_keypoints", "pred_peak_values",
                                                   "pred_instance_scores")]
    key = [tuple(np.round(np.nan_to_num(kp, nan=-1.0), 2).ravel()) for kp in arrays[0]]
    order = sorted(range(len(key)), key=key.__getitem__)
    return [a[order] for a in arrays]


def compare_outputs(got, want):
    """Batch outputs of the card (``got``) against the CPU's: keys, frame
    indices, validity, instance counts and NaN placement exact; each frame's
    instances, in canonical order, with keypoints and centroids to 1e-4 and
    values to 1e-5. Returns the largest differences and the instance
    count."""
    assert len(got) == len(want)
    err = {"keypoints_max_abs_err": 0.0, "values_max_abs_err": 0.0, "instances": 0}
    for g_out, w_out in zip(got, want):
        assert set(g_out) == set(w_out), (sorted(g_out), sorted(w_out))
        for key in ("frame_inds", "video_inds", "valid"):
            assert np.array_equal(g_out[key], w_out[key]), key
        for i in np.flatnonzero(w_out["valid"]):
            g_arrays, w_arrays = frame_instances(g_out, i), frame_instances(w_out, i)
            err["instances"] += len(w_arrays[0])
            for j, (g, w) in enumerate(zip(g_arrays, w_arrays)):
                assert g.shape == w.shape, (int(i), j, g.shape, w.shape)
                assert np.array_equal(np.isnan(g), np.isnan(w)), (int(i), j)
                which = "keypoints" if j in (0, 2) and g.ndim >= 2 else "values"
                diff = float(np.nanmax(np.abs(g - w), initial=0.0))
                err[f"{which}_max_abs_err"] = max(err[f"{which}_max_abs_err"], diff)
    if err["keypoints_max_abs_err"] > 1e-4 or err["values_max_abs_err"] > 1e-5:
        raise AssertionError(f"card vs CPU from model dirs: {err}")
    return err


# --------------------------------------------------------------------------
# Phase 15: tracked predict from the model directories of phase 13
# --------------------------------------------------------------------------

# Phase 15's second run: the Kalman tracker at the smoke's instance count.
# ``post_connect_single_breaks`` needs ``target_instance_count``.
KALMAN_TRACKING = {"use_kalman": True, "tracking_target_instance_count": MAX_INST,
                   "target_instance_count": MAX_INST, "post_connect_single_breaks": True}


def track_rows(labels):
    """Per frame (in order): its frame index and each instance's track name."""
    return [(lf.frame_idx, [i.track.name if i.track is not None else None for i in lf.instances])
            for lf in labels.labeled_frames]


def run_tracked_predict(kernels, dirs, model_type, card):
    """Phase 15: ``run.predict`` with ``tracking=True`` over phase 13's frames
    and knobs from trained model dirs: once with the default tracker (the
    counted run) and once with ``KALMAN_TRACKING``. Every instance carries a
    track, the Kalman run holds at most ``MAX_INST`` tracks, and each run's
    tracks equal those of ``run_tracker`` applied here to a deep copy of the
    same path's untracked ``Labels`` (``tracking=False``); the launches per
    batch are phase 13's; provenance records the knobs of a tracked run.
    Prints frames/s of the predict loop and tracking ms per frame."""
    import copy

    from sleap_nn_tpu_torch.inference.run import predict
    from sleap_nn_tpu_torch.tracking import run_tracker

    frames = smoke_frames()
    kw = dict(batch_size=BATCH, use_bf16=True, device=DEVICE, peak_threshold=DIR_PEAK_THRESHOLD,
              max_instances=MAX_INST)
    if model_type == "bottomup":
        kw.update(min_line_scores=DIR_MIN_LINE, max_peaks=DIR_MAX_PEAKS, paf_workers=0)
    predict(frame_labels(frames[:BATCH]), dirs, make_labels=False, **kw)  # warm-up
    untracked = predict(frame_labels(frames), dirs, **kw)
    sync()
    for k in kernels.values():
        k.launches = 0
    t0 = time.perf_counter()
    tracked = predict(frame_labels(frames), dirs, tracking=True, **kw)
    sync()
    total_s = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    n_batches = -(-N_FRAMES // BATCH)
    per_batch = {"topdown": (18, 1, 0), "bottomup": (9, 1, 1)}[model_type]
    want = dict(zip(("fused_double_conv3x3", "nms_scores", "paf_line_scores"),
                    (n * n_batches for n in per_batch)), multi_confmaps=0)
    if DEVICE != "cpu" and launches != want:  # a CPU rehearsal launches no kernel
        raise AssertionError(f"tracked {model_type}: launch counts {launches}, expected {want}")
    kalman = predict(frame_labels(frames), dirs, tracking=True, **KALMAN_TRACKING, **kw)

    stats = {"launches": launches, "n_batches": n_batches, "card": card}
    for name, labels, knobs in (("default", tracked, {}), ("kalman", kalman, KALMAN_TRACKING)):
        rows = track_rows(labels)
        if any(t is None for _, names in rows for t in names):
            raise AssertionError(f"tracked {model_type} ({name}): an instance has no track")
        if len(labels.labeled_frames) != N_FRAMES:
            raise AssertionError(f"tracked {model_type} ({name}): "
                                 f"{len(labels.labeled_frames)} frames")
        again = copy.deepcopy(untracked)
        t0 = time.perf_counter()
        run_tracker(again, **knobs)
        track_s = time.perf_counter() - t0
        if track_rows(again) != rows:
            raise AssertionError(f"tracked {model_type} ({name}): the tracks differ from "
                                 "run_tracker's on the untracked Labels")
        for lf, ref in zip(labels.labeled_frames, untracked.labeled_frames):
            if not all(np.array_equal(i.points, j.points, equal_nan=True)
                       for i, j in zip(lf.instances, ref.instances)):
                raise AssertionError(f"tracked {model_type} ({name}): points differ")
        if labels.provenance.get("tracking_config", {}) != knobs:
            raise AssertionError(f"tracked {model_type} ({name}): provenance "
                                 f"{labels.provenance.get('tracking_config')}")
        stats[name] = {"tracks": len(labels.tracks),
                       "instances": sum(len(lf) for lf in labels.labeled_frames),
                       "tracking_ms_per_frame": track_s * 1e3 / N_FRAMES,
                       "tracking_config": labels.provenance.get("tracking_config", {})}
    if stats["kalman"]["tracks"] > MAX_INST:
        raise AssertionError(f"tracked {model_type}: the Kalman run holds "
                             f"{stats['kalman']['tracks']} tracks")
    stats["fps"] = tracked.provenance["stats"]["fps"]
    stats["run_predict_s"] = total_s
    log(f"tracked_{model_type}_predict " + json.dumps(stats))
    log(f"tracked {model_type}: predict loop {stats['fps']:.2f} frames/s; tracking "
        f"{stats['default']['tracking_ms_per_frame']:.3f} ms/frame (default), "
        f"{stats['kalman']['tracking_ms_per_frame']:.3f} ms/frame (Kalman) | {card}")
    return stats


# --------------------------------------------------------------------------
# Phase 16: tracking and evaluation of narrow dirs, the card against the CPU
# --------------------------------------------------------------------------

TRACK_CLIP_FRAMES = 24
# The 3-step narrow models find dozens of centroids of similar value on a
# frame: phase 16 keeps each frame's best 2 instances (the gap to the
# third is about 0.03 in peak value, far above the devices' 1e-6) and
# tracks centroids by distance, which no float noise can tie.
TRACK_KNOBS = {"max_instances": 2, "tracking": True, "features": "centroids",
               "scoring_method": "euclidean_dist"}


def moving_blob_clip(n_frames, img, n_nodes, seed):
    """Phase 16's clip: two of phase 14's blob animals on straight paths
    (one from (24, 32) 2 px a frame right, one from (104, 96) 2 px a frame
    left, 64 px apart in y), the second one dimmer so that no two peaks
    tie, and their ground-truth ``Labels``: each animal's nodes at fixed
    offsets (a seeded draw) from its center."""
    from sleap_nn_tpu_torch.io.model import Instance, LabeledFrame, Labels, Skeleton

    rng = np.random.default_rng(seed)
    offsets = rng.normal(0, 4, (2, n_nodes, 2))
    yy, xx = np.mgrid[:img, :img]
    frames = np.zeros((n_frames, img, img, 1), np.float32)
    centers = np.array([[[24.0 + 2 * t, 32.0], [104.0 - 2 * t, 96.0]] for t in range(n_frames)])
    for t in range(n_frames):
        for (cx, cy), amp in zip(centers[t], (1.0, 0.8)):
            frames[t, ..., 0] += amp * np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 4.0 ** 2))
    video = ArrayVideo((np.clip(frames, 0, 1) * 255).astype(np.uint8))
    skel = Skeleton([f"n{i}" for i in range(n_nodes)], edges=bottomup_edges(n_nodes))
    gt = Labels([LabeledFrame(video, t, [Instance(centers[t, k] + offsets[k], skel)
                                         for k in range(2)]) for t in range(n_frames)])
    return video, gt


def same_metric(a, b, tol):
    """``a`` and ``b`` within ``tol``, or both NaN (no matched pair)."""
    return (np.isnan(a) and np.isnan(b)) or abs(a - b) <= tol


def check_tracking_against_cpu(dirs, tmp):
    """Phase 16: phase 14's narrow dirs predict ``moving_blob_clip`` with
    ``TRACK_KNOBS`` on the card and on the CPU: every instance's track the
    same on both (instances keyed by track, keypoints to 1e-4 px);
    ``run_evaluation`` against the clip's ground truth the same on both
    (``mOKS`` to 1e-6, ``dist.avg`` to 1e-4 px, the centroid mode's
    detection counts exact); the card's metrics survive ``save_metrics_npz``
    -> ``load_metrics``."""
    from sleap_nn_tpu_torch.evaluation import load_metrics, run_evaluation, save_metrics_npz
    from sleap_nn_tpu_torch.inference.run import predict
    from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels

    video, gt = moving_blob_clip(TRACK_CLIP_FRAMES, 128, 5, seed=16)
    report = {}
    for name, types, kw in NARROW_RUNS:
        paths = [dirs[t] for t in types]
        runs = {}
        for device in (DEVICE, "cpu"):
            src = Labels([LabeledFrame(video, t) for t in range(TRACK_CLIP_FRAMES)],
                         videos=[video])
            runs[device] = predict(src, paths, batch_size=4, device=device,
                                   **{**kw, **TRACK_KNOBS})
        card, cpu = runs[DEVICE], runs["cpu"]
        err, n_inst = 0.0, 0
        assert [lf.frame_idx for lf in card] == [lf.frame_idx for lf in cpu]
        for a, b in zip(card.labeled_frames, cpu.labeled_frames):
            by_track = [{i.track.name: i.points for i in lf.instances} for lf in (a, b)]
            if sorted(by_track[0]) != sorted(by_track[1]) or len(by_track[1]) != len(b):
                raise AssertionError(f"phase 16 {name}: frame {b.frame_idx} tracks "
                                     f"{sorted(by_track[0])} on the card, "
                                     f"{sorted(by_track[1])} on the CPU")
            for t, pts in by_track[1].items():
                assert np.array_equal(np.isnan(by_track[0][t]), np.isnan(pts)), (name, t)
                err = max(err, float(np.nanmax(np.abs(by_track[0][t] - pts), initial=0.0)))
            n_inst += len(b)
        if err > 1e-4 or n_inst < TRACK_CLIP_FRAMES:
            raise AssertionError(f"phase 16 {name}: keypoints {err} px apart, "
                                 f"{n_inst} instances")
        metrics = {d: (run_evaluation(gt, runs[d]), run_evaluation(gt, runs[d],
                                                                    match_method="centroid"))
                   for d in runs}
        (m_card, c_card), (m_cpu, c_cpu) = metrics[DEVICE], metrics["cpu"]
        pairs = {"mOKS": (m_card["mOKS"]["mOKS"], m_cpu["mOKS"]["mOKS"], 1e-6),
                 "dist.avg": (m_card["distance_metrics"]["avg"],
                              m_cpu["distance_metrics"]["avg"], 1e-4)}
        diffs = {k: abs(a - b) for k, (a, b, _) in pairs.items()}
        counts = [{k: c["detection_metrics"][k] for k in ("n_tp", "n_fp", "n_fn")}
                  for c in (c_card, c_cpu)]
        if not (all(same_metric(a, b, tol) for a, b, tol in pairs.values())
                and counts[0] == counts[1]):
            raise AssertionError(f"phase 16 {name}: metrics differ {diffs} {counts}")
        path = Path(tmp) / f"metrics.{name}.npz"
        save_metrics_npz(m_card, path)
        back = load_metrics(path)
        if not (same_metric(back["mOKS.mOKS"], m_card["mOKS"]["mOKS"], 0)
                and same_metric(back["distance_metrics"]["avg"],
                                m_card["distance_metrics"]["avg"], 0)):
            raise AssertionError(f"phase 16 {name}: the metrics file does not round-trip")
        report[name] = {"instances": n_inst, "tracks": len(card.tracks),
                        "keypoints_max_abs_err": err, "metric_diffs": diffs,
                        "mOKS": m_card["mOKS"]["mOKS"],
                        "dist_avg": m_card["distance_metrics"]["avg"],
                        "detection_counts": counts[0]}
    log("tracking_eval_card_vs_cpu " + json.dumps(report))
    return report


# --------------------------------------------------------------------------
# Phase 19: identity models from model dirs; narrow identity dirs, card against CPU
# --------------------------------------------------------------------------

# The narrow identity runs: name, the model types of its dirs, the
# predictor's knobs. Phase 14's centroid model finds about 45 centroids
# above 0.5 a frame, and a Hungarian match of 45 rows to 3 classes turns on
# small differences between rows: top-down keeps each frame's best 3
# centroids (the gaps between the 3rd and 4th value are 1e-4 and more,
# against the devices' 1e-6). The conditioned bottom-up maps peak near 1
# on the blobs.
NARROW_ID_RUNS = (("multi_class_topdown", ("centroid", "multi_class_topdown"),
                   {"max_instances": 3, "peak_threshold": 0.5}),
                  ("multi_class_bottomup", ("multi_class_bottomup",), {"peak_threshold": 0.5}))
NARROW_CLASSES = 3
# The 3-step class heads' outputs sit near uniform (rows of 0.29, 0.49,
# 0.21): their logits (and class-map pre-activations) are scaled by this
# much, so that most rows clear the bf16 margin the check asks for.
CLASS_HEAD_GAIN = 10.0


def train_narrow_identity_dirs(root, centroid_dir):
    """Phase 19's labels (phase 14's blob labels, each instance one of
    ``NARROW_CLASSES`` tracks) and its narrow multi-class dirs, each trained
    3 steps on the CPU under ``root/narrow_id``, conditioned as phase 14's
    and saved by the trainer, with the class heads' gain raised
    (``CLASS_HEAD_GAIN``); the top-down pair takes phase 14's centroid
    dir."""
    import torch

    from sleap_nn_tpu_torch.training import ModelTrainer

    labels = with_tracks(blob_labels(10, 128, 5, 3, seed=14), NARROW_CLASSES, seed=19)
    dirs = {"centroid": centroid_dir}
    for model_type in ("multi_class_bottomup", "multi_class_topdown"):
        cfg = training_config(8, 16, 128, 4, augment=False, model_type=model_type,
                              crop_size=64 if model_type == "multi_class_topdown" else None,
                              max_epochs=1, train_steps_per_epoch=3, save_ckpt=True,
                              ckpt_dir=str(root / "narrow_id"), run_name=model_type)
        trainer = ModelTrainer.get_model_trainer_from_config(
            cfg, [labels.extract(range(8))], [labels.extract(range(8, 10))], device="cpu")
        trainer.train()
        condition_weights(trainer.model, labels.video.frames)
        with torch.no_grad():
            for layer in trainer.model.head_layers:
                for head, module in layer.items():
                    if head == "ClassVectorsHead":
                        module.weight.mul_(CLASS_HEAD_GAIN)
                    elif head == "ClassMapsHead":
                        module[0].weight.mul_(CLASS_HEAD_GAIN)
        trainer.save_checkpoint("best.ckpt")
        dirs[model_type] = trainer.ckpt_dir
    return labels, dirs


def class_margin_ok(probs):
    """Per row of class probabilities: whether its best clears its second
    best by more than bf16's step at the best's magnitude."""
    top2 = np.sort(probs, axis=-1)[..., -2:]
    return np.array([b - a > bf16_ulp(float(b)) for a, b in top2.reshape(-1, 2)],
                    dtype=bool).reshape(top2.shape[:-1])


def _sorted_peaks(dev, i):
    """Sample ``i``'s valid peaks of a multi-class bottom-up device output,
    ordered by (channel, rough y, rough x): the same peaks, whatever order
    near-equal values gave them."""
    v = dev["valid"][i]
    rough = dev["rough"][i][v]
    order = np.lexsort((rough[:, 0], rough[:, 1], dev["channels"][i][v]))
    return {k: dev[k][i][v][order] for k in ("rough", "channels", "points", "peak_class_probs")}


def _identity_rows(fin, i):
    """Sample ``i`` of a multi-class top-down output: its valid rows in
    canonical order (by keypoints), as keypoints, class probabilities and
    class indices."""
    keep = fin["instance_valid"][i]
    kp = fin["pred_keypoints"][i][keep]
    key = [tuple(np.round(np.nan_to_num(k, nan=-1.0), 2).ravel()) for k in kp]
    order = sorted(range(len(key)), key=key.__getitem__)
    return (kp[order], fin["class_probs"][i][keep][order],
            fin["pred_class_inds"][i][keep][order])


def check_identity_dirs_against_cpu(labels, dirs):
    """Phase 19's narrow check: the dirs of ``train_narrow_identity_dirs``
    predict ``labels``' frames through their ``Predictor.from_model_paths``
    layers on the card and on the CPU, f32, batch 4. Validity, peak
    positions and NaN placement exact; keypoints to 1e-4 px, class
    probabilities to 1e-5; the class assignment equal wherever every row
    of one Hungarian match clears the bf16 step between its best and
    second-best class probability: a frame's instances (top-down), a
    (frame, node)'s peaks (bottom-up). Counts the rows under that margin
    and the matches they leave out."""
    from sleap_nn_tpu_torch.inference.layers import to_host
    from sleap_nn_tpu_torch.inference.predictor import Predictor

    frames = labels.video.frames
    report = {}
    for name, types, kw in NARROW_ID_RUNS:
        paths = [dirs[t] for t in types]
        layers = {d: Predictor.from_model_paths(paths, batch_size=4, device=d, **kw).layer
                  for d in (DEVICE, "cpu")}
        r = {"rows": 0, "rows_under_margin": 0, "matches": 0, "matches_left_out": 0,
             "keypoints_max_abs_err": 0.0, "probs_max_abs_err": 0.0}
        for start in range(0, len(frames), 4):
            chunk = frames[start:start + 4]
            dev = {d: to_host(layer.predict_async(chunk)) for d, layer in layers.items()}
            fin = {d: layers[d].postprocess_host(dict(dev[d])) for d in layers}
            g_dev, w_dev, g_fin, w_fin = dev[DEVICE], dev["cpu"], fin[DEVICE], fin["cpu"]
            for i in range(len(chunk)):
                if name == "multi_class_bottomup":
                    g, w = _sorted_peaks(g_dev, i), _sorted_peaks(w_dev, i)
                    for k in ("rough", "channels"):
                        if not np.array_equal(g[k], w[k], equal_nan=True):
                            raise AssertionError(f"phase 19 {name}: frame {start + i} peaks differ")
                    g_probs, probs = g["peak_class_probs"], w["peak_class_probs"]
                    # One match per node: its peaks, and its column of the
                    # output, whose NaN placement is the node's assignment.
                    matches = [(w["channels"] == n, (slice(None), n))
                               for n in np.unique(w["channels"])]
                    g_kp, w_kp = g_fin["pred_keypoints"][i], w_fin["pred_keypoints"][i]
                    g_cls, w_cls = np.isnan(g_kp), np.isnan(w_kp)
                else:  # one match per frame: its instances' class indices
                    g_kp, g_probs, g_cls = _identity_rows(g_fin, i)
                    w_kp, probs, w_cls = _identity_rows(w_fin, i)
                    if g_kp.shape != w_kp.shape:
                        raise AssertionError(f"phase 19 {name}: frame {start + i} holds "
                                             f"{len(g_kp)} / {len(w_kp)} instances")
                    matches = [(np.ones(len(probs), bool), slice(None))]
                ok = class_margin_ok(probs) if len(probs) else np.zeros(0, bool)
                r["rows"] += len(probs)
                r["rows_under_margin"] += int((~ok).sum())
                if len(probs):
                    r["probs_max_abs_err"] = max(r["probs_max_abs_err"],
                                                 float(np.abs(g_probs - probs).max()))
                for rows, cols in matches:
                    r["matches"] += 1
                    if not ok[rows].all():
                        r["matches_left_out"] += 1
                        continue
                    gk, wk = g_kp[cols], w_kp[cols]
                    if not (np.array_equal(g_cls[cols], w_cls[cols])
                            and np.array_equal(np.isnan(gk), np.isnan(wk))):
                        raise AssertionError(f"phase 19 {name}: frame {start + i}: the class "
                                             "assignments differ")
                    r["keypoints_max_abs_err"] = max(
                        r["keypoints_max_abs_err"], float(np.nanmax(np.abs(gk - wk), initial=0)))
        if r["keypoints_max_abs_err"] > 1e-4 or r["probs_max_abs_err"] > 1e-5:
            raise AssertionError(f"phase 19 {name}: card vs CPU {r}")
        if r["rows"] < len(frames) or r["matches_left_out"] > r["matches"] // 2:
            raise AssertionError(f"phase 19 {name}: too little compared {r}")
        report[name] = r
    log("identity_dirs_card_vs_cpu " + json.dumps(report))
    return report


# --------------------------------------------------------------------------


def kernel_summary(fused_rows, nms_rows, nms_bu_rows, paf_rows, paf_breakdown, cm_rows, runs):
    """The ``kernels`` line: one entry per kernel, launches from the paths'
    runs (``runs``: path name -> the phase's stats, with its ``launches``
    and ``n_batches``)."""
    main_path = [r for r in fused_rows if r["dtype"] == "bfloat16"]
    nms_main = next(r for r in nms_rows if r["dtype"] == "bfloat16" and r["kernel"] == 3)
    nms_bu = next(r for r in nms_bu_rows if r["dtype"] == "bfloat16")
    paf_main = next(r for r in paf_rows if r["dtype"] == "bfloat16")
    t_ops = sum(r["flops"] / PEAK_BF16 for r in main_path)
    t_bytes = sum(r["bytes"] / PEAK_BYTES for r in main_path)

    cm_main = next(r for r in cm_rows if r["path"] == "bottomup_train")

    def launches(kernel):
        by_path = {path: run["launches"][kernel] for path, run in runs.items()}
        return {"launches": sum(by_path.values()), "launches_by_path": by_path,
                "launches_per_batch": {path: n // runs[path]["n_batches"]
                                       for path, n in by_path.items()}}

    return {"kernels": [
        {
            "name": "fused_double_conv3x3", "route": "cuda",
            "source": "sleap_nn_tpu_torch/csrc/fused_double_conv3x3.cu",
            "replaces": "sleap_nn_tpu/ops/fused_conv.py:112",
            **launches("fused_double_conv3x3"),
            "max_abs_err": max(r["max_abs_err"] for r in fused_rows),
            "max_err": max(r["max_abs_err"] / r["tol"] for r in fused_rows),
            "tol": "bf16: 1 bf16 ulp at the output's largest magnitude; f32: 1e-4 x that magnitude",
            "max_err_ulps": max(r["err_ulps"] for r in main_path),
            "timing": "kernel_ms: graph_ms of bare launches with pre-packed weights; "
                      "wrapper_ms: calls of fused_double_conv3x3 (weights packed once, cached); "
                      "pack_ms: packing both weights of every call anew",
            "ms": sum(r["kernel_ms"] for r in main_path),
            "kernel_ms": sum(r["kernel_ms"] for r in main_path),
            "wrapper_ms": sum(r["wrapper_ms"] for r in main_path),
            "pack_ms": sum(r["pack_ms"] for r in main_path),
            "tflops": sum(r["flops"] for r in main_path) / sum(r["kernel_ms"] for r in main_path)
            / 1e9,
            "plain_ms": sum(r["plain_ms"] for r in main_path),
            "bound_ms": sum(r["bound_ms"] for r in main_path),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in main_path),
            "shapes": "the 18 bf16 calls of one top-down batch (9 centroid UNet @ 8x1024^2, "
                      "9 instance UNet @ 48x256^2); times summed. The bottom-up and "
                      "single-instance UNets' 9 calls have the centroid UNet's shapes",
        },
        {
            "name": "nms_scores", "route": "cuda",
            "source": "sleap_nn_tpu_torch/csrc/nms_scores.cu",
            "replaces": "sleap_nn_tpu/ops/pallas_kernels.py:116",
            **launches("nms_scores"),
            "max_abs_err": max(r["max_abs_err"] for r in nms_rows + nms_bu_rows),
            "max_err": max(r["max_abs_err"] for r in nms_rows + nms_bu_rows),
            "tol": "exact",
            "ms": nms_main["kernel_ms"], "kernel_ms": nms_main["kernel_ms"],
            "wrapper_ms": nms_main["wrapper_ms"],
            "plain_ms": nms_main["plain_ms"], "bound_ms": nms_main["bound_ms"],
            "bound_by": nms_main["bound_by"], "library_ms": None,
            "shapes": "(8, 512, 512, 1) bf16, k=3",
            "bottomup": {k: nms_bu[k] for k in ("x", "kernel_ms", "wrapper_ms", "plain_ms",
                                                 "bound_ms", "bound_by", "n_peaks")},
            "centroid_eval": {"launches": runs["train"]["eval_renders"],
                              **runs["train"]["eval_peaks"]},
        },
        {
            "name": "paf_line_scores", "route": "cuda",
            "source": "sleap_nn_tpu_torch/csrc/paf_line_scores.cu",
            "replaces": "sleap_nn_tpu/ops/pallas_kernels.py:204",
            **launches("paf_line_scores"),
            "max_abs_err": max(r["max_abs_err"] for r in paf_rows),
            "tol": "1e-5 absolute on finite scores; -inf and NaN placement exact",
            "ms": paf_main["kernel_ms"], "kernel_ms": paf_main["kernel_ms"],
            "wrapper_ms": paf_main["wrapper_ms"],
            "plain_ms": paf_main["plain_ms"], "bound_ms": paf_main["bound_ms"],
            "bound_by": paf_main["bound_by"], "library_ms": None,
            "gather_ms": paf_main["gather_ms"],
            "gather_note": "advanced-index gather of the x and y samples only (what the TPU "
                           "kernel computed), not the scoring",
            "paf_scoring_breakdown": {k: v for k, v in paf_breakdown.items() if k != "profiler"},
            "shapes": f"PAFs {paf_main['pafs']} bf16, peaks {paf_main['peaks']}, "
                      f"{N_POINTS} line points, {paf_main['valid_pairs']} valid pairs",
        },
        {
            "name": "multi_confmaps", "route": "cuda",
            "source": "sleap_nn_tpu_torch/csrc/multi_confmaps.cu",
            "replaces": "sleap_nn_tpu/ops/pallas_kernels.py:35",
            **launches("multi_confmaps"),
            "max_abs_err": max(r["max_abs_err"] for r in cm_rows),
            "tol": "1e-6 absolute",
            "ms": cm_main["kernel_ms"], "kernel_ms": cm_main["kernel_ms"],
            "wrapper_ms": cm_main["wrapper_ms"],
            "plain_ms": cm_main["plain_ms"], "bound_ms": cm_main["bound_ms"],
            "bound_by": cm_main["bound_by"], "library_ms": None,
            "timing": "kernel_ms: 20 launches of the C entry captured in a CUDA graph; "
                      "wrapper_ms: 20 calls of multi_confmaps between events",
            "shapes": f"points {cm_main['points']} -> {cm_main['out']} f32 (bottom-up training "
                      "targets; launches_per_batch counts renders: train steps, val batches "
                      "and the setup probe)",
            "zeros_exact": all(r["zeros_exact"] for r in cm_rows),
            "train_bottomup_path_max_abs_err":
                runs["train_bottomup"]["stage_ms"]["render_parts"]["confmaps_max_abs_err"],
            "other_cases": {r["path"]: {k: r[k] for k in ("points", "out", "kernel_ms",
                                                          "wrapper_ms", "plain_ms", "bound_ms",
                                                          "bound_by", "max_abs_err")}
                            for r in cm_rows if r is not cm_main},
        },
    ]}


# --------------------------------------------------------------------------


def main() -> int:
    try:
        import torch
    except ImportError:
        print("torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    try:
        from sleap_nn_tpu_torch.config.model_config import UNetMediumRFConfig
        from sleap_nn_tpu_torch.ops import _build, fused_conv, kernels  # noqa: F401
    except ImportError as exc:
        print(f"the port package is not beside this script: {exc}", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # 1. Device report.
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"device: {name} | torch {torch.__version__} cuda {torch.version.cuda}")
    log(f"nvidia-smi: {smi}")

    # 2. Build.
    build_s = _build.build()
    log(f"build: {build_s:.2f} s for {len(_build.KERNELS)} kernels")
    for k in _build.KERNELS.values():
        for line in k.build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {k.name}: {line.strip()}")

    sass = sass_tensor_ops(fused_conv.KERNEL)
    log(f"sass fused_double_conv3x3: {json.dumps(sass)}")
    if sass is not None and not sass["HMMA"] + sass["HGMMA"]:
        raise AssertionError("fused_double_conv3x3's SASS holds no tensor-core instruction")

    # 3. Kernels against their plain versions, at the paths' shapes.
    cfg, centroid, instance = build_models(UNetMediumRFConfig, N_NODES, seed=0)
    layer = build_layer(cfg, centroid, instance, DEVICE, True, CROP, MAX_INST)
    bu_cfg, bu_model = build_bottomup_model(UNetMediumRFConfig, N_NODES, seed=3,
                                            frames=smoke_frames()[:2])
    bu_layer = build_bottomup_layer(bu_cfg, bu_model, DEVICE, True, MAX_INST)
    rng = np.random.default_rng(0)
    fused_rows = check_fused(layer, rng)
    nms_rows = check_nms(rng)
    nms_bu_rows = check_nms(rng, channels=N_NODES, ks=(3,))
    paf_rows = check_paf(bu_layer, smoke_frames()[:BATCH])
    cm_rows = check_confmaps(rng)
    check_fused_refuses_autograd()

    # 4. Top-down end to end through Predictor.predict.
    e2e = run_end_to_end(layer, _build.KERNELS)

    # 5. Bottom-up end to end through Predictor.predict.
    bu = run_bottomup_end_to_end(bu_layer, _build.KERNELS)

    # 6. Card against CPU on a small input.
    check_against_cpu()
    check_bottomup_against_cpu()

    # 7. Centroid training end to end, into a model dir that phase 13 loads,
    # with the epoch-end evaluation.
    runs_dir = tempfile.TemporaryDirectory()
    root = Path(runs_dir.name)
    tr = run_training_end_to_end(_build.KERNELS, root, evaluate=True)

    # 8. Training on the card against the CPU.
    check_training_against_cpu()

    # 9. Single-instance end to end through Predictor.predict.
    si_layer = build_single_instance_layer(UNetMediumRFConfig, N_NODES, seed=6, device=DEVICE,
                                           use_bf16=True)
    si = run_single_instance_end_to_end(si_layer, _build.KERNELS)

    # 10. Bottom-up training end to end (kernel 4 at 15 nodes).
    tr_bu = run_training_end_to_end(_build.KERNELS, root, "bottomup")

    # 11. Centered-instance training end to end.
    tr_ci = run_training_end_to_end(_build.KERNELS, root, "centered_instance", crop_size=CROP,
                                    evaluate=True)

    # 12. Training of the other model types on the card against the CPU.
    for model_type in ("single_instance", "centered_instance", "bottomup"):
        check_training_against_cpu(model_type)

    # 13. run.predict from the model dirs of phases 7 + 11 and of phase 10.
    dir_td = run_model_dir_predict(_build.KERNELS, [root / "centroid", root / "centered_instance"],
                                   "topdown")
    dir_bu = run_model_dir_predict(_build.KERNELS, [root / "bottomup"], "bottomup")

    # 14. Narrow model dirs trained on the CPU, predicted on the card and the CPU.
    narrow_labels, narrow_dirs = train_narrow_dirs(root)
    check_model_dirs_against_cpu(narrow_labels, narrow_dirs)

    # 15. Tracked run.predict from the model dirs of phase 13.
    t_phase = time.perf_counter()
    tracked_td = run_tracked_predict(_build.KERNELS, [root / "centroid",
                                                      root / "centered_instance"],
                                     "topdown", smi)
    tracked_bu = run_tracked_predict(_build.KERNELS, [root / "bottomup"], "bottomup", smi)
    log(f"phase 15: {time.perf_counter() - t_phase:.1f} s")

    # 16. Tracking and evaluation of the narrow dirs, the card against the CPU.
    t_phase = time.perf_counter()
    check_tracking_against_cpu(narrow_dirs, root)
    log(f"phase 16: {time.perf_counter() - t_phase:.1f} s")

    # 17. Multi-class bottom-up training end to end (kernel 4, class maps).
    t_phase = time.perf_counter()
    tr_mbu = run_training_end_to_end(_build.KERNELS, root, "multi_class_bottomup")
    log(f"phase 17: {time.perf_counter() - t_phase:.1f} s")

    # 18. Multi-class centered-instance training end to end (class vectors).
    t_phase = time.perf_counter()
    tr_mtd = run_training_end_to_end(_build.KERNELS, root, "multi_class_topdown",
                                     crop_size=CROP, evaluate=True)
    log(f"phase 18: {time.perf_counter() - t_phase:.1f} s")

    # 19. run.predict of the identity models from their dirs; narrow
    # identity dirs on the card against the CPU.
    t_phase = time.perf_counter()
    dir_mbu = run_model_dir_predict(_build.KERNELS, [root / "multi_class_bottomup"],
                                    "multi_class_bottomup")
    dir_mtd = run_model_dir_predict(_build.KERNELS, [root / "centroid",
                                                     root / "multi_class_topdown"],
                                    "multi_class_topdown")
    id_labels, id_dirs = train_narrow_identity_dirs(root, narrow_dirs["centroid"])
    check_identity_dirs_against_cpu(id_labels, id_dirs)
    log(f"phase 19: {time.perf_counter() - t_phase:.1f} s")
    runs_dir.cleanup()

    # Phase 3's breakdown of the paf_scoring stage runs last: it opens a
    # torch.profiler window, which must not slow the timed phases above.
    paf_breakdown = paf_scoring_breakdown(bu_layer, smoke_frames()[:BATCH])

    runs = {"topdown": e2e, "bottomup": bu, "single_instance": si, "train": tr,
            "train_bottomup": tr_bu, "train_centered_instance": tr_ci,
            "model_dir_topdown": dir_td, "model_dir_bottomup": dir_bu,
            "tracked_topdown": tracked_td, "tracked_bottomup": tracked_bu,
            "train_multi_class_bottomup": tr_mbu, "train_multi_class_topdown": tr_mtd,
            "model_dir_multi_class_bottomup": dir_mbu, "model_dir_multi_class_topdown": dir_mtd}
    summary = kernel_summary(fused_rows, nms_rows, nms_bu_rows, paf_rows, paf_breakdown, cm_rows,
                             runs)
    summary["kernels"][0]["sass_tensor_ops"] = sass
    training = "; ".join(
        f"{name} {run['steps_per_sec']:.2f} steps/s, {run['samples_per_sec']:.2f} samples/s "
        f"(last 5-step epoch), {run['fixed_batch_steps_per_sec']:.2f} steps/s over 20 steps on "
        f"one batch" for name, run in (("centroid", tr), ("bottom-up", tr_bu),
                                       ("centered-instance", tr_ci),
                                       ("multi-class bottom-up", tr_mbu),
                                       ("multi-class centered-instance", tr_mtd)))
    log(f"e2e: top-down {e2e['fps']:.2f} frames/s over {e2e['n_frames']} frames "
        f"({e2e['instances']} instances); bottom-up {bu['fps']:.2f} frames/s "
        f"({bu['instances']} instances; {bu['paf_workers_2']['fps']:.2f} frames/s with 2 "
        f"grouping workers); single-instance {si['fps']:.2f} frames/s; from model dirs "
        f"(run.predict, bf16, peak_threshold {DIR_PEAK_THRESHOLD:g}, a 3-batch smoke figure): "
        f"top-down {dir_td['fps']:.2f} frames/s ({dir_td['instances']} instances), bottom-up "
        f"{dir_bu['fps']:.2f} frames/s ({dir_bu['instances']} instances), multi-class bottom-up "
        f"{dir_mbu['fps']:.2f} frames/s ({dir_mbu['instances']} instances), multi-class "
        f"top-down {dir_mtd['fps']:.2f} frames/s ({dir_mtd['instances']} instances); "
        f"training: {training}; "
        f"total script {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
