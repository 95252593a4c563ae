"""One run of one cell: what an entry is given, what it returns, and the
result line built from it.

The harness is driven by ``BENCHMARK.json`` and by files found by name:

- ``configs``' ``file``: the configuration (sizes, sources, changed keys);
- ``portbench/traffic/<traffic>.json``: the mix, whose ``entry`` names
  the runner ``portbench/entries/<entry>.py`` (a ``run(ctx) -> Outcome``);
- ``portbench/limits/<workload>.json``: the limit of each number the
  cell's comparison reports;
- ``portbench/metrics/<metric>.py``: the reader of a per-layer metric, a
  ``read(outcome, ctx)`` that returns a number, or None when the run has
  nothing for it to read (the metric is then left out of the line).
"""

from __future__ import annotations

import importlib.util
import json
import math
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

PKG = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sleap_nn_tpu")


@dataclass
class RunContext:
    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    limits: Dict[str, Dict[str, float]]
    seed: int
    seconds: float
    trace: bool
    device: str = "cuda"
    chips: int = 1
    t_process: float = 0.0
    marks: list = field(default_factory=list)  # (what, perf_counter) of the set-up

    def sync(self) -> None:
        if self.device != "cpu":
            import torch

            torch.cuda.synchronize()

    def memory_peak(self) -> int:
        """The peak of device memory allocated on the fullest card so far."""
        if self.device == "cpu":
            return 0
        import torch

        return max(torch.cuda.max_memory_allocated(d) for d in range(self.chips))

    def trace_span(self) -> Tuple[float, float]:
        """(start after the window's start, length) of the traced stretch, s."""
        tr = self.traffic
        return (min(tr["trace_start_s"], 0.3 * self.seconds),
                min(tr["trace_seconds"], 0.4 * self.seconds))


@dataclass
class Outcome:
    """What an entry's run gives back."""

    setup_s: float
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, Optional[float]] = field(default_factory=dict)
    record: Dict[str, Any] = field(default_factory=dict)  # what the readers read
    trace: Any = None  # a core.trace.TraceData of a traced run
    checks: Dict[str, float] = field(default_factory=dict)
    memory_peak_bytes: int = 0


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark by its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(f"portbench_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(spec: Dict, name: str, root: Path) -> Dict[str, Any]:
    """Everything a cell names, found by name: its workload entry, config,
    traffic, limits, entry module path and its metrics."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    cfg_entry = {c["name"]: c for c in spec["configs"]}[w["config"]]
    traffic = load_json(PKG / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (name in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return {
        "workload": w,
        "config": load_json(root / cfg_entry["file"]),
        "traffic": traffic,
        "limits": load_json(PKG / "limits" / f"{name}.json"),
        "entry": PKG / "entries" / f"{traffic['entry']}.py",
        "end_to_end": e2e,
        "per_layer": layer,
    }


def forbidden_modules(modules) -> List[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m for m in modules if m.split(".")[0] in FORBIDDEN})


def judge_checks(checks: Dict[str, float], limits: Dict[str, Dict]) -> Tuple[bool, Dict]:
    """(every number within its limit, ``{name: {"value", "limit", "bound"}}``).

    A limit is ``{"max": x}`` (the number may not exceed it) or ``{"min":
    x}`` (it may not fall below it). Only numbers with a limit are
    compared; a limit without its number fails."""
    rows, ok = {}, True
    for name in sorted(limits):
        value, lim = checks.get(name), limits.get(name) or {}
        bound = "min" if "min" in lim else "max"
        limit = lim.get(bound)
        rows[name] = {"value": value, "limit": limit, "bound": bound}
        good = value is not None and limit is not None and math.isfinite(value)
        ok &= good and (value >= limit if bound == "min" else value <= limit)
    return bool(ok), rows


def result(ctx: RunContext, out: Outcome, e2e: List[Dict], per_layer: List[Dict],
           device: Dict) -> Tuple[Dict, List[str]]:
    """The result line and the lines for standard error that end a run."""
    metrics: Dict[str, Dict] = {}
    if ctx.trace:
        for m in per_layer:
            value = load_module(PKG / "metrics" / f"{m['name']}.py").read(out, ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        if out.trace is not None:
            device = dict(device, busy_s=out.trace.busy_s(), window_s=out.trace.window_s)
    else:
        for m in e2e:
            value = out.setup_s if m["name"] == "setup_s" else out.e2e.get(m["name"])
            if value is None:
                raise RuntimeError(f"the run measured no {m['name']}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    ok, rows = judge_checks(out.checks, ctx.limits)
    correct = ok and out.failed == 0 and out.attempted > 0
    line = {"correct": correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": dict(device, memory_peak_bytes=out.memory_peak_bytes)}
    if ctx.trace and out.trace is not None:
        line["breakdown"] = out.trace.breakdown()
    line["checks"] = rows
    err = [f"set-up {k}: {v:.3f} s" for k, v in out.record.get("setup_marks", {}).items()]
    err += [f"check {name}: {r['value']} ({r['bound']} {r['limit']})" for name, r in rows.items()]
    err.append(f"correct: {correct} (attempted {out.attempted}, failed {out.failed})")
    return line, err
