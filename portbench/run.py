"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port (``sleap_nn_tpu_torch``). The cell's configuration, traffic
mix, entry, limits and metric readers are found by name (see
``core/run.py``). ``--trace 0`` prints the cell's end-to-end metrics,
``--trace 1`` its per-layer metrics from a run with a bounded device
trace. The last lines on standard error give each number the comparison
with the plain reference checked, beside its limit; the last line on
standard output is the result as one JSON object.

Exits 3 without a CUDA device (or with fewer than the cell asks for) and 4
if JAX or the JAX package was loaded, in both cases printing no result.
Build and compile caches stay inside the checkout, at fixed paths: the
port's kernels in ``sleap_nn_tpu_torch/_build/``, the compilers' caches
under ``.portbench_cache/``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"  # transformers, where something imports it, loads no JAX
    os.environ["USE_JAX"] = "0"
    sys.path.insert(0, str(ROOT))

    from portbench.core.run import RunContext, cell_files, forbidden_modules, load_json, \
        load_module, result

    spec = load_json(ROOT / "BENCHMARK.json")
    files = cell_files(spec, args.workload, ROOT)
    chips = int(files["workload"]["chips"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    ctx = RunContext(workload=files["workload"], config=files["config"],
                     traffic=files["traffic"], limits=files["limits"],
                     seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                     device="cuda", chips=chips, t_process=T_PROCESS)
    outcome = load_module(files["entry"]).run(ctx)
    found = forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}
    line, err = result(ctx, outcome, files["end_to_end"], files["per_layer"], device)
    sys.stdout.flush()
    for row in err:
        print(row, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
