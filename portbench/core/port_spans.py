"""The port's own spans and counters of a traced run, as the per-layer
readers take them.

The port records spans and counter samples while any profiler runs
(``sleap_nn_tpu_torch/profiling.py``: ``spans()``, ``counts()``), keyed by
a predict batch's ordinal or a training step's index. A traced predict
run holds two stretches, the device alone and then host operators too,
which slow the host; only the records that begin within the first
stretch's length (its lead and window) of the first record are kept. A
port without the recorder gives nothing, and the readers None.
"""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple


def stretch(spans: List, counts: List, seconds: float) -> Optional[Tuple[List, List]]:
    """The spans and samples that begin within ``seconds`` of the first."""
    starts = [s.start_ns for s in spans] + [c.t_ns for c in counts]
    if not starts:
        return None
    end = min(starts) + seconds * 1e9
    return [s for s in spans if s.start_ns <= end], [c for c in counts if c.t_ns <= end]


def recorded(out) -> Optional[Tuple[List, List]]:
    """(spans, counter samples) of the traced run's device-only stretch, or
    None where the run has no trace or the port recorded none."""
    trace = out.trace
    if trace is None:
        return None
    try:
        from sleap_nn_tpu_torch import profiling

        spans, counts = profiling.spans(), profiling.counts()
    except (ImportError, AttributeError):
        return None
    return stretch(spans, counts, trace.lead_us / 1e6 + trace.window_s)


def host_ms(span) -> float:
    return (span.end_ns - span.start_ns) / 1e6


def device_ms(span) -> Optional[float]:
    return span.device_ms


def per_key(spans: List, name: str, value=host_ms) -> Dict:
    """``value`` of the spans named ``name``, summed over each key; a key
    with a span that has no such value is left out."""
    out: Dict = {}
    missing = set()
    for s in spans:
        if s.name != name or s.key is None:
            continue
        v = value(s)
        if v is None:
            missing.add(s.key)
        else:
            out[s.key] = out.get(s.key, 0.0) + v
    return {k: v for k, v in out.items() if k not in missing}


def median(values) -> Optional[float]:
    values = list(values)
    return statistics.median(values) if values else None


def median_per_key(out, name: str, value=host_ms) -> Optional[float]:
    """The median over keys of :func:`per_key`, or None."""
    got = recorded(out)
    return None if got is None else median(per_key(got[0], name, value).values())
