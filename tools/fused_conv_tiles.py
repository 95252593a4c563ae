#!/usr/bin/env python3
"""Time the bf16 fused double-conv kernel at every tile and variant it can take.

For each double-conv call of one top-down batch of the UNet medium_rf pair
(9 centroid calls at 8 x 1024^2, 9 instance calls at 48 x 256^2), this
builds the kernel, launches it at every output tile of
``ops/fused_conv.py::TILES`` that fits shared memory and at each kernel
variant (2 or 1 resident blocks an SM), and prints the fastest choice
beside the planner's (``plan_tiles``). Times are device ms of one launch,
from a CUDA graph of bare launches (``chip_smoke.graph_ms``). Inputs are
ReLU features and He-normal weights from a seed. Needs one CUDA GPU:

    python3 tools/fused_conv_tiles.py [--json out.json]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent

# (block, x shape, c_mid, c_out): medium_rf's 9 blocks at the centroid and
# instance shapes of chip_smoke's top-down batch.
_MEDIUM_RF = [("enc0", 0, 1, 24), ("enc1", 1, 24, 36), ("enc2", 2, 36, 54), ("enc3", 3, 54, 81),
              ("enc4", 4, 81, 121), ("dec0", 4, 303, 121), ("dec1", 3, 202, 81),
              ("dec2", 2, 135, 54), ("dec3", 1, 90, 36)]
CALLS = [(f"{model}_{name}", (bsz, size >> lvl, size >> lvl, c_in), c, c)
         for model, bsz, size in (("centroid", 8, 1024), ("instance", 48, 256))
         for name, lvl, c_in, c in _MEDIUM_RF]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json", help="write every timing to this file")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from sleap_nn_tpu_torch.ops import fused_conv as fc

    rng = np.random.default_rng(0)
    rows, best_sum, plan_sum = [], 0.0, 0.0
    print(torch.cuda.get_device_name(0), flush=True)
    for name, shape, c_mid, c_out in CALLS:
        c_in = shape[-1]
        x = torch.from_numpy(np.maximum(rng.standard_normal(shape, dtype=np.float32), 0))
        x = x.cuda().to(torch.bfloat16)
        w1 = torch.randn(3, 3, c_in, c_mid, device="cuda") * (2 / (9 * c_in)) ** 0.5
        w2 = torch.randn(3, 3, c_mid, c_out, device="cuda") * (2 / (9 * c_mid)) ** 0.5
        zeros = torch.zeros(max(c_mid, c_out), device="cuda")
        p1 = fc._pack(w1, zeros[:c_mid], torch.bfloat16)
        p2 = fc._pack(w2, zeros[:c_out], torch.bfloat16)
        y = torch.empty(*shape[:3], c_out, device="cuda", dtype=torch.bfloat16)
        times = {}
        for (th, tw), (minb, _) in itertools.product(fc.TILES, fc.VARIANTS):
            if fc.smem_bytes(th, tw, c_in, c_mid, c_out) > fc.SMEM_LIMIT:
                continue

            def launch(th=th, tw=tw, minb=minb):
                fc.KERNEL.launch(
                    x.data_ptr(), None, p1[0].data_ptr(), p1[1].data_ptr(), p2[0].data_ptr(),
                    p2[1].data_ptr(), y.data_ptr(), *shape, c_in, c_mid, c_out, 1, 1, th, tw,
                    minb, torch.cuda.current_stream().cuda_stream)

            launch()
            torch.cuda.synchronize()
            times[f"{th}x{tw}/{minb}"] = chip_smoke.graph_ms(launch, reps=5)
        plan = fc.plan_tiles(*shape, c_mid, c_out)
        picked = f"{plan.tile_h}x{plan.tile_w}/{plan.blocks_per_sm}"
        best = min(times, key=times.get)
        best_sum += times[best]
        plan_sum += times[picked]
        print(f"{name} {list(shape)} -> {c_mid} -> {c_out}: fastest {best} {times[best]:.4f} ms, "
              f"planner {picked} {times[picked]:.4f} ms", flush=True)
        rows.append(dict(call=name, x=list(shape), c_mid=c_mid, c_out=c_out, times_ms=times,
                         fastest=best, planner=picked))
    print(f"sum over the {len(CALLS)} calls: fastest {best_sum:.4f} ms, planner {plan_sum:.4f} ms")
    if args.json:
        Path(args.json).write_text(json.dumps(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
