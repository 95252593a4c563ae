#!/usr/bin/env python3
"""Find where the card and the CPU part on phase 14's narrow model dirs.

    python3 tools/model_dir_divergence.py [--device cuda] [--out DIR]

Trains ``chip_smoke.py``'s phase-14 dirs (``train_narrow_dirs``: narrow
centroid, centered-instance and bottom-up models, 3 steps on the CPU),
once as trained and once conditioned as phase 14 predicts them, and for
each runs the peak stages of the top-down and bottom-up paths on
``--device`` and on the CPU in f32, on the same frames (batches of 4), with
three sets of knobs: phase 14's (``NARROW_RUNS``: a top-down peak
threshold of 0.5), and the same at ``run.predict``'s default threshold
(0.2) and with every local maximum counted as a peak (phase 13's
``DIR_PEAK_THRESHOLD``):

- top-down stage 1: the centroid maps' local peaks, refined over a 5x5
  patch (``find_local_peaks``), each device on its own frames;
- top-down stage 2: the centered-instance maps of the CPU's crops, on
  both devices (the card's own crops are held to the CPU's too), their
  global peaks refined over a 5x5 window;
- bottom-up: the multi-instance maps' local peaks, refined as stage 1.

Peaks are matched across the devices by (sample, channel, rough pixel).
For the matched peak whose refined point parts most, it reports where
(frame, slot, node), the rough peak on each device, and for the 5x5 patch
around the CPU's rough peak on each map (the device's, the CPU's, and a
second CPU witness: the same model and input in f64) the patch mass, the
mass of its absolute values and the refined offset in frame pixels. Over
all matched peaks it reports the smallest ratio of |mass| to absolute
mass, and the largest move of a refined point between the f32 and f64
CPU maps. It also runs ``run.predict`` on both devices and reports
``chip_smoke.compare_outputs``'s verdict. Prints one JSON line per (dirs,
knobs, path) and writes them all to ``--out``/divergence.json.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
PATCH = 5


def patch_stats(cm, x, y, stride, origin=(0.0, 0.0)):
    """The 5x5 patch of the 2-D map ``cm`` around the rough peak (x, y)
    (cells outside the map count 0), in f64: its mass, absolute mass and
    the integrally refined point in frame pixels."""
    r = PATCH // 2
    h, w = cm.shape
    d = np.arange(-r, r + 1, dtype=np.float64)
    v = np.zeros((PATCH, PATCH))
    for j, dy in enumerate(d):
        for i, dx in enumerate(d):
            yy, xx = int(y + dy), int(x + dx)
            if 0 <= yy < h and 0 <= xx < w:
                v[j, i] = cm[yy, xx]
    z = v.sum()
    off = (np.array([(v * d[None, :]).sum(), (v * d[:, None]).sum()]) / z) if z else np.zeros(2)
    point = (np.array([x, y], np.float64) + off) * stride + np.asarray(origin, np.float64)
    return {"mass": float(z), "abs_mass": float(np.abs(v).sum()),
            "refined_px": [float(point[0]), float(point[1])]}


def peak_table(points, rough, channels, valid, frame0):
    """Matched-peak key (frame, channel, rough x, rough y) -> (refined x, y, slot)."""
    table = {}
    for b, k in zip(*np.nonzero(valid)):
        key = (frame0 + int(b), int(channels[b, k]), int(rough[b, k, 0]), int(rough[b, k, 1]))
        table[key] = (points[b, k], int(k))
    return table


def compare_peaks(tables, maps, stride, what):
    """Match the two devices' peaks; the worst one's patches on each map."""
    dev, cpu = tables
    common = sorted(set(dev) & set(cpu))
    report = {"stage": what, "peaks_device": len(dev), "peaks_cpu": len(cpu),
              "matched": len(common)}
    if not common:
        return report
    diffs = [float(np.abs(dev[k][0] - cpu[k][0]).max()) * stride for k in common]
    worst = common[int(np.argmax(diffs))]
    frame, ch, x, y = worst
    report["max_part_px"] = max(diffs)
    report["parted_over_1e-4_px"] = int(sum(d > 1e-4 for d in diffs))
    report["worst"] = {"frame": frame, "channel": ch, "slot_cpu": cpu[worst][1],
                       "rough": [x, y],
                       **{name: patch_stats(m[frame][..., ch], x, y, stride)
                          for name, m in maps.items()}}
    ratios, moves = [], []
    for k in common:
        frame, ch, x, y = k
        p32 = patch_stats(maps["cpu_f32"][frame][..., ch], x, y, stride)
        p64 = patch_stats(maps["cpu_f64"][frame][..., ch], x, y, stride)
        ratios.append(abs(p32["mass"]) / p32["abs_mass"] if p32["abs_mass"] else 1.0)
        moves.append(float(np.abs(np.subtract(p32["refined_px"], p64["refined_px"])).max()))
    report["min_mass_ratio"] = float(min(ratios))
    report["f32_vs_f64_max_move_px"] = float(max(moves))
    report["f32_vs_f64_moves_over_1_px"] = int(sum(m > 1.0 for m in moves))
    return report


def f64_maps(backend, x, head):
    """The maps of ``backend``'s model run in f64 on the CPU on ``x``."""
    import torch

    model = copy.deepcopy(backend.model).to("cpu", torch.float64)
    with torch.inference_mode():
        return model(x.to("cpu", torch.float64))[head].numpy()


def topdown_peaks(layers, frames, batch):
    """Stage 1 and stage 2 peaks of the top-down layers, per device."""
    import torch

    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.ops.crops import crop_bboxes, make_centered_bboxes
    from sleap_nn_tpu_torch.ops.peaks import (
        find_global_peaks_rough,
        find_local_peaks,
        refine_global_peaks_windowed,
    )

    names = list(layers)
    t1 = {n: {} for n in names}
    t2 = {n: {} for n in names}
    maps1 = {"device": [], "cpu_f32": [], "cpu_f64": []}
    maps2 = {"device": [], "cpu_f32": [], "cpu_f64": []}
    crop_err = 0.0
    for b0 in range(0, len(frames), batch):
        imgs = frames[b0:b0 + batch]
        crops = {}
        for n in names:
            layer = layers[n]
            c, inst = layer.centroid_layer, layer.instance_layer
            with torch.inference_mode():
                x, eff = preprocess_images(c.pre, torch.from_numpy(imgs).to(layer.device))
                cms = c.backend(x)[c.head_name]
                p, v, ch, valid, rough = find_local_peaks(
                    cms, threshold=c.post.peak_threshold, refinement=c.post.refinement,
                    integral_patch_size=c.post.integral_patch_size,
                    max_peaks=c.post.max_instances or c.post.max_peaks, return_rough=True)
                k = layer.max_instances
                cent = torch.nan_to_num(p[:, :k] * c.output_stride, nan=-1e6)
                flat = cent.reshape(-1, 2)
                sample = torch.arange(len(imgs), device=layer.device).repeat_interleave(k)
                crops[n] = crop_bboxes(x, make_centered_bboxes(
                    flat, layer.crop_size, layer.crop_size), sample,
                    layer.crop_size, layer.crop_size).cpu()
            t1[n].update(peak_table(p.cpu().numpy(), rough.cpu().numpy(), ch.cpu().numpy(),
                                    valid.cpu().numpy(), b0))
            maps1["device" if n == "device" else "cpu_f32"].extend(cms.cpu().numpy())
            if n == "cpu":
                maps1["cpu_f64"].extend(f64_maps(c.backend, x, c.head_name))
                slot_valid = valid[:, :k].reshape(-1).cpu().numpy()
        crop_err = max(crop_err, float((crops["device"] - crops["cpu"]).abs().max()))
        for n in names:  # stage 2 on the CPU's crops
            inst = layers[n].instance_layer
            with torch.inference_mode():
                cms2 = inst.backend(crops["cpu"].to(layers[n].device))[inst.head_name]
                rough2, _ = find_global_peaks_rough(cms2, threshold=inst.post.peak_threshold)
                ref2 = refine_global_peaks_windowed(cms2, rough2, inst.post.integral_patch_size)
            rough2, ref2 = rough2.cpu().numpy(), ref2.cpu().numpy()
            ok = ~np.isnan(rough2).any(-1) & slot_valid[:, None]
            n_nodes = ok.shape[1]
            t2[n].update(peak_table(
                ref2, np.nan_to_num(rough2), np.broadcast_to(np.arange(n_nodes), ok.shape), ok,
                len(maps2["cpu_f32"])))
            maps2["device" if n == "device" else "cpu_f32"].extend(cms2.cpu().numpy())
            if n == "cpu":
                maps2["cpu_f64"].extend(f64_maps(inst.backend, crops["cpu"], inst.head_name))
    return (t1, maps1), (t2, maps2), crop_err


def bottomup_peaks(layers, frames, batch):
    """The bottom-up layers' refined local peaks, per device."""
    import torch

    from sleap_nn_tpu_torch.inference.layers import preprocess_images
    from sleap_nn_tpu_torch.ops.peaks import find_local_peaks

    tables = {n: {} for n in layers}
    maps = {"device": [], "cpu_f32": [], "cpu_f64": []}
    for b0 in range(0, len(frames), batch):
        for n, layer in layers.items():
            post = layer.post
            with torch.inference_mode():
                x, _ = preprocess_images(layer.pre, torch.from_numpy(
                    frames[b0:b0 + batch]).to(layer.device))
                cms = layer.backend(x)[layer.cm_head]
                p, v, ch, valid, rough = find_local_peaks(
                    cms, threshold=post.peak_threshold, refinement=post.refinement,
                    integral_patch_size=post.integral_patch_size, max_peaks=post.max_peaks,
                    return_rough=True)
            tables[n].update(peak_table(p.cpu().numpy(), rough.cpu().numpy(),
                                        ch.cpu().numpy(), valid.cpu().numpy(), b0))
            maps["device" if n == "device" else "cpu_f32"].extend(cms.cpu().numpy())
            if n == "cpu":
                maps["cpu_f64"].extend(f64_maps(layer.backend, x, layer.cm_head))
    return tables, maps


def diagnose(root, device, condition):
    import chip_smoke as cs
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.run import predict

    labels, dirs = cs.train_narrow_dirs(root, condition=condition)
    frames = labels.video.frames
    lines = []
    runs = [(knobs, name, types, dict(kw, **extra))
            for knobs, extra in (("phase14", {}), ("default_threshold", {"peak_threshold": 0.2}),
                                 ("every_local_max", {"peak_threshold": cs.DIR_PEAK_THRESHOLD}))
            for name, types, kw in cs.NARROW_RUNS]
    for knobs, name, types, kw in runs:
        paths = [dirs[t] for t in types]
        layers = {n: Predictor.from_model_paths(paths, batch_size=4, device=d, **kw).layer
                  for n, d in (("device", device), ("cpu", "cpu"))}
        line = {"dirs": "conditioned" if condition else "as_trained", "knobs": knobs,
                "path": name, "device": device, "peak_threshold": kw.get("peak_threshold", 0.2)}
        if name == "topdown":
            (t1, m1), (t2, m2), crop_err = topdown_peaks(layers, frames, 4)
            stride1 = layers["cpu"].centroid_layer.output_stride
            stride2 = layers["cpu"].instance_layer.output_stride
            line["stages"] = [
                compare_peaks((t1["device"], t1["cpu"]), m1, stride1, "centroid local peaks"),
                compare_peaks((t2["device"], t2["cpu"]), m2, stride2,
                              "centered-instance global peaks (frame = crop row)")]
            line["crops_max_abs_diff"] = crop_err
        else:
            tables, maps = bottomup_peaks(layers, frames, 4)
            line["stages"] = [compare_peaks((tables["device"], tables["cpu"]), maps,
                                            layers["cpu"].cm_output_stride,
                                            "multi-instance local peaks")]
        runs = [predict(cs.frame_labels(frames), paths, batch_size=4, make_labels=False,
                        device=d, **kw) for d in (device, "cpu")]
        try:
            line["run_predict"] = cs.compare_outputs(*runs)
        except AssertionError as exc:
            line["run_predict"] = {"failed": str(exc)}
        lines.append(line)
        print("divergence " + json.dumps(line), flush=True)
    return lines


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=str(ROOT / "_work" / "divergence"))
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        for condition in (False, True):
            lines += diagnose(Path(tmp) / ("cond" if condition else "raw"), args.device,
                              condition)
    (out / "divergence.json").write_text(json.dumps(lines, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
