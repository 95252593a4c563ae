"""The readings a cell's limits are set from, in one process.

    python3 portbench/tools/readings.py <cell> <seconds> <first seed> <n program> <n control> [fault]

Runs the cell's entry on ``n program`` seeds with the program, then on
``n control`` seeds with the control in its place, each with a window of
``seconds``, and prints one JSON line a run (``{"who", "seed", "checks",
...}``) and, last, the largest and smallest reading of each number for
each side. A limit lies above the program's largest reading and below
the control's smallest (see ``PERF.md``). For a predict cell the control
is ``reference/control.py``'s layer; for a training cell it is the
reference with TF32 on, judged on the rows of the program's own run of
the same seed (the first ``n control`` seeds). With ``fault`` (a name of
``tools/faults.py``) the program runs with that fault planted instead.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def main(argv):
    from portbench.core.run import RunContext, cell_files, load_json, load_module
    from portbench.reference.control import control_layer
    from portbench.tools.faults import FAULTS

    cell, seconds, first, n_prog, n_ctl = argv[0], float(argv[1]), int(argv[2]), int(argv[3]), int(argv[4])
    fault = FAULTS[argv[5]] if len(argv) > 5 else None
    files = cell_files(load_json(ROOT / "BENCHMARK.json"), cell, ROOT)
    entry = load_module(files["entry"])
    seen = {"program": {}, "control": {}}
    train = files["traffic"]["entry"] == "train"

    def keep(who, seed, checks, **more):
        print(json.dumps({"who": who, "seed": seed, "checks": checks, **more}), flush=True)
        for k, v in checks.items():
            seen[who].setdefault(k, []).append(v)

    for who, n, make in (("program", n_prog, None), ("control", 0 if train else n_ctl,
                                                      control_layer)):
        for i in range(n):
            seed = first + i
            ctx = RunContext(workload=files["workload"], config=files["config"],
                             traffic=files["traffic"], limits=files["limits"], seed=seed,
                             seconds=seconds, trace=False, device="cuda",
                             t_process=time.perf_counter())
            if who == "program" and fault is not None:
                out = entry.run(ctx, fault)
            elif train:
                out = entry.run(ctx, with_control=i < n_ctl)
            else:
                out = entry.run(ctx, make) if make else entry.run(ctx)
            keep(who, seed, out.checks, e2e=out.e2e, attempted=out.attempted,
                 notes=out.record.get("judge_notes"), setup=out.record.get("setup_marks"))
            if "control_checks" in out.record:
                keep("control", seed, out.record["control_checks"])
    summary = {who: {k: {"max": max(v), "min": min(v)} for k, v in d.items()}
               for who, d in seen.items()}
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
