"""A bounded device trace of a steady part of the window, read in memory.

``Tracer`` starts ``torch.profiler`` and stops it after a
``torch.cuda.synchronize()``, since the profiler drops device records it
has not received when it stops. Nothing is written to disk. With
``cpu=False`` it records the device alone, without the host operators'
correlation, which costs the host least; with ``cpu=True`` also the
host's operators and the benchmark's ``record_function`` ranges on every
thread, which slows a host-paced pipeline, so such a stretch is read only
for device times by kernel. The first ``lead_s`` of a stretch, in which
the profiler's start held up the host, is left out of its busy and idle
time.
:meth:`Tracer.read` turns the events into a :class:`TraceData`:

- ``device``: every device interval (kernels, copies, sets) as
  ``(name, start_us, end_us)``, relative to the trace's start;
- ``spans``: the benchmark's own spans, as ``(name, start_us, end_us)``:
  those it noted on the host clock (:meth:`Tracer.note`) and its
  ``record_function`` ranges (names starting with ``portbench.``);
- ``launched``: each kernel a benchmark span launched itself (not through
  an operator inside it), as ``(span name, span start_us, kernel name,
  device us)``, linked through the launch's correlation.

The profiler's first start initialises CUPTI, which takes seconds:
:meth:`Tracer.prepare` does that in set-up, so that the start inside the
window is quick.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

SPAN_PREFIX = "portbench."


@dataclass
class TraceData:
    window_s: float  # the stretch read, after its lead
    lead_us: float = 0.0
    device: List[Tuple[str, float, float]] = field(default_factory=list)
    spans: List[Tuple[str, float, float]] = field(default_factory=list)
    launched: List[Tuple[str, float, str, float]] = field(default_factory=list)

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of device intervals inside the window, sorted (us from
        the window's start)."""
        end_w = self.window_s * 1e6
        merged: List[List[float]] = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s - self.lead_us, 0.0), min(e - self.lead_us, end_w)
            if e <= s:
                continue
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def gaps(self) -> List[Tuple[float, float]]:
        """Idle stretches of the device inside the window (us)."""
        out, t = [], 0.0
        for s, e in self.busy_intervals():
            if s > t:
                out.append((t, s))
            t = e
        if self.window_s * 1e6 > t:
            out.append((t, self.window_s * 1e6))
        return out

    def host_during(self, t0: float, t1: float) -> str:
        """The benchmark spans that overlap ``[t0, t1]``, longest overlap first."""
        over: Dict[str, float] = {}
        for name, s, e in self.spans:
            o = min(e - self.lead_us, t1) - max(s - self.lead_us, t0)
            if o > 0:
                over[name] = over.get(name, 0.0) + o
        names = sorted(over, key=lambda n: -over[n])[:3]
        return "+".join(n[len(SPAN_PREFIX):] for n in names) or "no benchmark span"

    def breakdown(self, n: int = 10) -> Dict[str, list]:
        """The device operations that took most time and the longest idle
        gaps with what the host was doing, in seconds as measured."""
        by_name: Dict[str, float] = {}
        end_w = self.window_s * 1e6
        for name, s, e in self.device:
            s, e = max(s - self.lead_us, 0.0), min(e - self.lead_us, end_w)
            if e > s:
                by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:n]
        return {"device_ops": [[name[:160], s] for name, s in ops],
                "idle_gaps": [[self.host_during(s, e), (e - s) / 1e6] for s, e in gaps]}


class Tracer:
    """One profiled stretch; ``start`` and ``stop`` on one thread."""

    def __init__(self, cuda: bool = True, cpu: bool = False, lead_s: float = 0.0):
        self.cuda, self.cpu, self.lead_s = cuda, cpu, lead_s
        self._prof = None
        self._t0 = self._t1 = None
        self._notes: List[Tuple[str, int, int]] = []

    def note(self, name: str, t0_ns: int, t1_ns: int) -> None:
        """A span of the benchmark's on the host (``time.time_ns()``), kept
        while the trace runs."""
        if self.running:
            self._notes.append((name, t0_ns, t1_ns))

    def prepare(self) -> None:
        """Start and stop the profiler once around a small device operation."""
        import torch

        self.start()
        torch.ones(1, device="cuda" if self.cuda else "cpu").sum()
        self.stop()
        self._prof.events()
        self._prof = None
        self._t0 = self._t1 = None
        self._notes = []

    @property
    def started_at(self) -> Optional[float]:
        return self._t0

    @property
    def running(self) -> bool:
        return self._prof is not None and self._t1 is None

    @property
    def done(self) -> bool:
        return self._t1 is not None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        kw = {}
        # Host operators: those of every thread. The device alone: no
        # correlation with host operators, which would hook every operator.
        option = {"profile_all_threads": True} if self.cpu or not self.cuda else \
            {"disable_external_correlation": True}
        try:
            kw["experimental_config"] = torch._C._profiler._ExperimentalConfig(**option)
        except (AttributeError, TypeError):
            pass
        acts = ([ProfilerActivity.CPU] if self.cpu or not self.cuda else []) + \
            ([ProfilerActivity.CUDA] if self.cuda else [])
        self._prof = profile(activities=acts, **kw)
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self) -> None:
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self._t1 = time.perf_counter()
        self._prof.stop()

    def read(self) -> Optional[TraceData]:
        if self._prof is None or self._t1 is None:
            return None
        from torch.autograd import DeviceType

        data = TraceData(window_s=max(self._t1 - self._t0 - self.lead_s, 1e-9),
                         lead_us=self.lead_s * 1e6)
        events = list(self._prof.events())
        try:
            start_ns = self._prof.profiler.kineto_results.trace_start_ns()
        except AttributeError:
            start_ns = None
        if start_ns is not None:
            data.spans += [(SPAN_PREFIX + n, (a - start_ns) / 1e3, (b - start_ns) / 1e3)
                           for n, a, b in self._notes]
        # Device events by correlation id, to find the kernel of a launch.
        by_corr: Dict[int, List] = {}
        for ev in events:
            if ev.device_type == DeviceType.CUDA and not ev.name.startswith(SPAN_PREFIX):
                for key in {ev.id, getattr(ev, "linked_correlation_id", 0)} - {0}:
                    by_corr.setdefault(key, []).append(ev)
        for ev in events:
            s, e = ev.time_range.start, ev.time_range.end
            span = ev.name.startswith(SPAN_PREFIX)
            if ev.device_type == DeviceType.CUDA:
                if not span and not getattr(ev, "is_user_annotation", False):
                    data.device.append((ev.name, s, e))
                continue
            # A kernel a span launched itself: hung on the span, or on the
            # runtime's launch right under it (an operator inside the span
            # holds its own), else found by the launch's correlation id.
            if span:
                data.spans.append((ev.name, s, e))
                data.launched += [(ev.name, s, k.name, float(k.duration)) for k in ev.kernels]
            elif "LaunchKernel" in ev.name and ev.cpu_parent is not None \
                    and ev.cpu_parent.name.startswith(SPAN_PREFIX):
                parent = ev.cpu_parent
                kernels = [(k.name, float(k.duration)) for k in ev.kernels] or [
                    (d.name, d.time_range.end - d.time_range.start) for d in by_corr.get(ev.id, [])]
                data.launched += [(parent.name, parent.time_range.start, n, dur)
                                  for n, dur in kernels]
        data.launched = sorted(set(data.launched), key=lambda t: t[1])
        self._prof = None
        return data
