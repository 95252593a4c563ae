"""Does a ``torch.profiler`` trace on this card hold every kernel it ran?

    KINETO_LOG_LEVEL=1 python3 tools/trace_lost_records.py [RUNS]

Runs ``chip_smoke.py``'s phase 38 (``run_monitored_training``: the
medium_rf centroid and bottom-up trainings with every monitor, traced by
``profiling.trace``) ``RUNS`` times (default 3) after building the
kernels. For each trace it prints one ``trace_records`` JSON line: the
device kernel events, the host's kernel launch records, how many launch
records have no kernel event with their correlation id (records the
profiler dropped) and when (seconds from the trace's first event), and
the seconds at which each of kernels 2 and 4 ran. ``KINETO_LOG_LEVEL=1``
makes the profiler log its own record counts ("Out-of-range" are the GPU
records it dropped as timed outside the trace's window). Then ``run N ok``
or ``run N FAILED`` with phase 38's message.
"""

import json
import subprocess
import sys
from pathlib import Path


def records(trace_dir, trace_names):
    from sleap_nn_tpu_torch.profiling import trace_files

    (f,) = trace_files(trace_dir)
    events = json.loads(f.read_text())["traceEvents"]
    kern = [e for e in events if e.get("cat") == "kernel"]
    seen = {e.get("args", {}).get("correlation") for e in kern}
    launches = [e for e in events if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "LaunchKernel" in e.get("name", "")]
    lost = [e for e in launches if e.get("args", {}).get("correlation") not in seen]
    t0 = min(e["ts"] for e in events if "ts" in e)
    at = {k: [round((e["ts"] - t0) / 1e6, 3) for e in kern if any(s in e["name"] for s in subs)]
          for k, subs in trace_names.items()}
    return {"kernel_events": len(kern), "launch_records": len(launches), "lost": len(lost),
            "lost_at_s": sorted({round((e["ts"] - t0) / 1e6, 3) for e in lost})[:20],
            "port_kernels_at_s": at}


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import torch

    import chip_smoke as cs
    from sleap_nn_tpu_torch.ops import _build

    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    real = cs.trace_kernels

    def traced(trace_dir):
        print("trace_records " + json.dumps({**records(trace_dir, cs.TRACE_NAMES), "smi": smi}),
              flush=True)
        return real(trace_dir)

    cs.trace_kernels = traced
    for i in range(int(sys.argv[1]) if len(sys.argv) > 1 else 3):
        try:
            cs.run_monitored_training(_build.KERNELS, smi)
            print("run", i, "ok", flush=True)
        except AssertionError as exc:
            print("run", i, "FAILED", exc, flush=True)
