"""The card's idle gaps in a traced run of a cell, put down to the port's
own spans, and the run's spans and counters summed up.

    python3 portbench/tools/idle_by_span.py <cell> <seed> [--seconds 40] [--out FILE]

Runs the cell as ``run.py --trace 1`` does (its result line is printed
as usual), with ``Tracer.read`` wrapped to keep Kineto's
``trace_start_ns()`` of the device-only stretch; then places the port's
spans (``sleap_nn_tpu_torch.profiling``, stamped with ``time.time_ns()``)
on that trace's time base and puts each idle gap of the card down to the
innermost span open across it on each thread (the one that covers most
of the gap). Prints Markdown tables: idle time by what the launching
thread was in, the longest gaps, each span's median host and device ms,
the counters, and for a predict cell each batch's time from its read to
its emit, split by span. ``--out`` also writes them as JSON. The host
and device clocks of a card may disagree by a fraction of a millisecond:
a gap shorter than that skew is not placed reliably.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path
from typing import Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
LAUNCHER = "MainThread"  # the thread that enqueues a batch or runs a step
BATCH = ["provider.make", "provider.queued", "predict.enqueue", "predict.in_flight",
         "predict.postprocess", "predict.emit"]


def _median(xs) -> Optional[float]:
    xs = list(xs)
    return statistics.median(xs) if xs else None


def place(gap, spans_by_thread: Dict) -> Dict[str, str]:
    """Each thread's innermost span across ``gap`` (us on the trace's time
    base): the one that covers most of it, the later start on a tie."""
    g0, g1 = gap
    out = {}
    for thread, spans in spans_by_thread.items():
        best = None
        for name, s, e in spans:
            over = min(e, g1) - max(s, g0)
            if over > 0 and (best is None or (over, s) > best[:2]):
                best = (over, s, name)
        out[thread] = best[2] if best else "-"
    return out


def idle_tables(spans: List, names: Dict[int, str], start_ns: int, data) -> Dict:
    """The gaps of ``data`` (a ``TraceData``) placed among ``spans``."""
    by_thread: Dict[str, list] = {}
    for s in spans:
        if s.thread is not None:
            by_thread.setdefault(names.get(s.thread, str(s.thread)), []).append(
                (s.name, (s.start_ns - start_ns) / 1e3, (s.end_ns - start_ns) / 1e3))
    gaps = [(s + data.lead_us, e + data.lead_us) for s, e in data.gaps()]
    placed = [(e - s, place((s, e), by_thread)) for s, e in gaps]
    idle_us = sum(d for d, _ in placed)
    by_launcher: Dict[str, list] = {}
    for d, where in placed:
        by_launcher.setdefault(where.get(LAUNCHER, "-"), []).append(d)
    rows = sorted(([name, len(ds), sum(ds) / 1e3, 100.0 * sum(ds) / max(idle_us, 1e-9)]
                   for name, ds in by_launcher.items()), key=lambda r: -r[2])
    longest = sorted(placed, key=lambda p: -p[0])[:12]
    return {"window_s": data.window_s, "idle_ms": idle_us / 1e3, "n_gaps": len(gaps),
            "by_launcher": rows,
            "longest": [[d / 1e3, " | ".join(f"{t}: {n}" for t, n in sorted(w.items()))]
                        for d, w in longest]}


def span_table(spans: List, counts: List) -> Dict:
    by_name: Dict[str, list] = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    rows = []
    for name, ss in sorted(by_name.items()):
        keys = {s.key for s in ss}
        rows.append([name, len(ss), len(ss) / max(len(keys), 1),
                     _median((s.end_ns - s.start_ns) / 1e6 for s in ss),
                     _median(s.device_ms for s in ss if s.device_ms is not None)])
    by_count: Dict[str, list] = {}
    for c in counts:
        by_count.setdefault(c.name, []).append(c.value)
    return {"spans": rows,
            "counters": [[n, len(v), sum(v) / len(v), min(v), max(v)]
                         for n, v in sorted(by_count.items())]}


def batch_split(spans: List) -> Optional[Dict]:
    """Each predict batch's time from its read to its emit, split by span:
    the medians, and the means over the batches at or past the 95th
    percentile of that time."""
    parts: Dict = {}
    for s in spans:
        if s.name in BATCH and s.key is not None:
            parts.setdefault(s.key, {})[s.name] = s
    whole = {k: p for k, p in parts.items() if len(p) == len(BATCH)}
    if len(whole) < 2:
        return None
    total = {k: (p["predict.emit"].end_ns - p["provider.make"].start_ns) / 1e6
             for k, p in whole.items()}
    cut = statistics.quantiles(total.values(), n=20)[-1]
    tail = [k for k, t in total.items() if t >= cut]

    def ms(k, name):
        s = whole[k][name]
        return (s.end_ns - s.start_ns) / 1e6

    return {"batches": len(whole), "p95_ms": cut, "median_ms": _median(total.values()),
            "rows": [[name, _median(ms(k, name) for k in whole),
                      statistics.fmean(ms(k, name) for k in tail)] for name in BATCH],
            "device_ms_median": _median(whole[k]["predict.enqueue"].device_ms for k in whole
                                        if whole[k]["predict.enqueue"].device_ms is not None)}


def _fmt(x):
    return "-" if x is None else (f"{x:.3f}" if isinstance(x, float) else str(x))


def markdown(report: Dict) -> str:
    idle, lines = report["idle"], []
    lines += [f"Idle {idle['idle_ms']:.3f} ms in {idle['n_gaps']} gaps over "
              f"{idle['window_s']:.3f} s", "",
              f"| {LAUNCHER} in | gaps | idle ms | share % |", "|---|---|---|---|"]
    lines += ["| " + " | ".join(_fmt(x) for x in row) + " |" for row in idle["by_launcher"]]
    lines += ["", "| longest gap ms | each thread in |", "|---|---|"]
    lines += [f"| {d:.3f} | {w} |" for d, w in idle["longest"]]
    tab = report["spans"]
    lines += ["", "| span | count | a key | median host ms | median device ms |",
              "|---|---|---|---|---|"]
    lines += ["| " + " | ".join(_fmt(x) for x in row) + " |" for row in tab["spans"]]
    lines += ["", "| counter | samples | mean | min | max |", "|---|---|---|---|---|"]
    lines += ["| " + " | ".join(_fmt(x) for x in row) + " |" for row in tab["counters"]]
    split = report.get("batch_split")
    if split:
        lines += ["", f"{split['batches']} batches, read to emit: median "
                  f"{split['median_ms']:.3f} ms, p95 {split['p95_ms']:.3f} ms; the card "
                  f"{_fmt(split['device_ms_median'])} ms a batch (median)", "",
                  "| span | median ms | mean ms past p95 |", "|---|---|---|"]
        lines += ["| " + " | ".join(_fmt(x) for x in row) + " |" for row in split["rows"]]
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cell")
    ap.add_argument("seed", type=int)
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from portbench.core import trace as core_trace

    kept = {}
    read = core_trace.Tracer.read

    def read_keeping_start(self):
        prof = self._prof
        data = read(self)
        if data is not None and not self.cpu:
            kept["device"] = (prof.profiler.kineto_results.trace_start_ns(), data)
        return data

    core_trace.Tracer.read = read_keeping_start
    from portbench import run as bench

    rc = bench.main(["--workload", args.cell, "--seed", str(args.seed),
                     "--seconds", str(args.seconds), "--trace", "1"])
    if rc or "device" not in kept:
        return rc or 1
    from sleap_nn_tpu_torch import profiling

    from portbench.core.port_spans import stretch

    start_ns, data = kept["device"]
    spans, counts = stretch(profiling.spans(), profiling.counts(),
                            data.lead_us / 1e6 + data.window_s)
    report = {"cell": args.cell, "seed": args.seed, "trace_start_ns": start_ns,
              "idle": idle_tables(spans, profiling.thread_names(), start_ns, data),
              "spans": span_table(spans, counts), "batch_split": batch_split(spans)}
    print(markdown(report))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
