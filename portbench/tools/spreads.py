"""Spreads of a cell's runs, for setting the bounds of ``BENCHMARK.json``.

    python3 portbench/tools/spreads.py RUNS.jsonl [RUNS.jsonl ...]

Each line of a file is ``{"set": 1 or 2, "seed": n, "line": <run.py's
result line>}`` (``set`` 0 marks a traced run, which is left out). For
each end-to-end metric and set: the median, the first and third
quartiles (``statistics.quantiles(values, n=4)``) and the spread, their
distance over the median; then the wider of the two sets' spreads and
five times it, the bound it suggests (never under 1%). The first run of a
file, which builds the kernels, is left out of ``setup_s``.
"""

from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List


def spread(values: List[float]) -> Dict[str, float]:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return {"median": med, "q1": q1, "q3": q3, "spread": (q3 - q1) / med if med else 0.0}


def main(paths: List[str]) -> None:
    for path in paths:
        rows = [json.loads(line) for line in open(path) if line.strip()]
        runs = [r for r in rows if r.get("set") in (1, 2) and r.get("line")]
        first = runs[0] if runs else None
        names = sorted({m for r in runs for m in r["line"]["metrics"]})
        print(path, "correct:", sum(r["line"]["correct"] for r in rows if r.get("line")),
              "of", sum(1 for r in rows if r.get("line")))
        for name in names:
            widest = 0.0
            for s in (1, 2):
                vals = [r["line"]["metrics"][name]["value"] for r in runs
                        if r["set"] == s and not (name == "setup_s" and r is first)]
                if len(vals) >= 3:
                    st = spread(vals)
                    widest = max(widest, st["spread"])
                    print(f"  {name:24s} set {s}: median {st['median']:.6g}  q1 {st['q1']:.6g}"
                          f"  q3 {st['q3']:.6g}  spread {st['spread']:.4%}")
            print(f"  {name:24s} widest {widest:.4%} -> bound {max(5 * widest, 0.01):.4f}")


if __name__ == "__main__":
    main(sys.argv[1:])
