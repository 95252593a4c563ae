#!/usr/bin/env python3
"""Hold kernels 3 and 4 of two checkouts against each other on the card.

    python3 tools/kernel_outputs.py --against PATH_TO_OTHER_CHECKOUT

Makes the inputs once, with this checkout: kernel 4's (``multi_confmaps``)
are ``chip_smoke.py``'s four cases, and kernel 3's (``paf_line_scores``)
are the smoke's bottom-up PAFs and grouped peaks of one batch (UNet
medium_rf, random weights from the smoke's seed), in bf16 and f32 at the
path's 10 line points, in bf16 at 5 and 32, and in bf16 at stride 3 (no
power of two). Then each checkout, in a subprocess of its own that builds
its kernels, renders every case through the public wrappers and times each
(``chip_smoke.graph_ms``: 20 wrapper calls in a CUDA graph, so the host's
work is not timed), in the order this, other, this, other. Prints one JSON
line with, per case, the count of elements whose bits differ and both
sides' ms; exits 1 if any output differs.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent


def make_inputs(out: Path) -> None:
    """Save every case's inputs under ``out`` (``cases.json`` and ``.npy``)."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    import torch

    from sleap_nn_tpu_torch.config.model_config import UNetMediumRFConfig
    from sleap_nn_tpu_torch.inference.paf_grouping import line_fractions

    cases = {}
    rng = np.random.default_rng(0)
    for name, n_nodes, sigma, kind in cs.confmap_cases():
        np.save(out / f"{name}.points.npy", cs.confmap_points(rng, n_nodes, kind))
        cases[name] = {"kernel": "multi_confmaps", "size": cs.TRAIN_IMG, "sigma": 2 * sigma}
    cfg, model = cs.build_bottomup_model(UNetMediumRFConfig, cs.N_NODES, seed=3,
                                         frames=cs.smoke_frames()[:2])
    layer = cs.build_bottomup_layer(cfg, model, "cuda", True, cs.MAX_INST)
    pafs, gp, mask = cs.paf_inputs(layer, cs.smoke_frames()[:cs.BATCH])
    scorer = layer.paf_scorer
    for key, x in (("pafs", pafs.float()), ("peaks", gp), ("mask", mask),
                   ("edges", torch.tensor(scorer.edge_inds, dtype=torch.int32))):
        np.save(out / f"paf.{key}.npy", x.cpu().numpy())
    max_len = scorer.max_edge_length_ratio * max(pafs.shape[1], pafs.shape[2],
                                                 2 * scorer.n_edges) * scorer.pafs_stride
    for name, dtype, n_points, stride in (
            ("paf_bf16", "bfloat16", cs.N_POINTS, scorer.pafs_stride),
            ("paf_f32", "float32", cs.N_POINTS, scorer.pafs_stride),
            ("paf_bf16_p5", "bfloat16", 5, scorer.pafs_stride),
            ("paf_bf16_p32", "bfloat16", 32, scorer.pafs_stride),
            ("paf_bf16_stride3", "bfloat16", cs.N_POINTS, 3)):
        np.save(out / f"{name}.t.npy", line_fractions(n_points, "cpu").numpy())
        cases[name] = {"kernel": "paf_line_scores", "dtype": dtype, "stride": stride,
                       "max_len": max_len, "weight": scorer.dist_penalty_weight}
    (out / "cases.json").write_text(json.dumps(cases))


def render(root: Path, inputs: Path, out: Path) -> None:
    """Render and time every case with the package under ``root``."""
    sys.path.insert(0, str(root))
    import torch

    # This checkout's timer, whichever checkout's package renders.
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    from sleap_nn_tpu_torch.ops.grid import make_grid_vectors
    from sleap_nn_tpu_torch.ops.kernels import multi_confmaps, paf_line_scores

    dev = torch.device("cuda")

    def load(name):
        return torch.from_numpy(np.load(inputs / f"{name}.npy")).to(dev)

    paf = {k: load(f"paf.{k}") for k in ("pafs", "peaks", "mask", "edges")}
    times = {}
    for name, c in json.loads((inputs / "cases.json").read_text()).items():
        if c["kernel"] == "multi_confmaps":
            pts = load(f"{name}.points")
            xv, yv = make_grid_vectors(c["size"], c["size"], 2, device=dev)
            call = lambda: multi_confmaps(pts, xv, yv, c["sigma"])  # noqa: E731
        else:
            pafs = paf["pafs"].to(getattr(torch, c["dtype"])).contiguous()
            t = load(f"{name}.t")
            call = lambda: paf_line_scores(  # noqa: E731
                pafs, paf["peaks"], paf["mask"], paf["edges"], t, c["stride"], c["max_len"],
                c["weight"])
        np.save(out / f"{name}.npy", call().cpu().numpy())
        times[name] = cs.graph_ms(call)
    (out / "times.json").write_text(json.dumps(times))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", type=Path, help="the other checkout's root")
    ap.add_argument("--render", nargs=3, type=Path, metavar=("ROOT", "INPUTS", "OUT"),
                    help="render and time the saved cases with the package under ROOT")
    args = ap.parse_args()
    if args.render is not None:
        render(*(p.resolve() for p in args.render))
        return 0
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "inputs"
        inputs.mkdir()
        make_inputs(inputs)
        roots = {"this": ROOT, "other": args.against.resolve()}
        runs = []
        for i, side in enumerate(("this", "other", "this", "other")):
            out = Path(tmp) / f"{side}{i}"
            out.mkdir()
            subprocess.run([sys.executable, __file__, "--render", str(roots[side]), str(inputs),
                            str(out)], check=True, timeout=600)
            runs.append((side, out))
        report = {}
        for path in sorted(runs[0][1].glob("*.npy")):
            a, b = np.load(path), np.load(runs[1][1] / path.name)
            fin = np.isfinite(a) & np.isfinite(b)
            report[path.stem] = {
                "shape": list(a.shape),
                "bits_differ": int((a.view(np.int32) != b.view(np.int32)).sum()),
                "max_abs_diff": float(np.abs(a[fin] - b[fin]).max()) if fin.any() else 0.0,
                **{f"{side}_ms": [json.loads((out / "times.json").read_text())[path.stem]
                                  for s, out in runs if s == side] for side in roots},
            }
    same = all(r["bits_differ"] == 0 for r in report.values())
    print("kernel_outputs " + json.dumps({"against": str(args.against), "identical": same,
                                          "cases": report}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
