"""A profiler trace of a training or predict run, and the port's own spans.

Where the JAX package wraps a run in ``jax.profiler.trace(dir)``, the port
wraps it in :func:`trace`: ``torch.profiler`` records the host's operators
and, on a card, the CUDA kernels and copies (through CUPTI), and
``tensorboard_trace_handler`` writes one Chrome trace file,
``<worker>.<time>.pt.trace.json``, into the directory when the block ends.
TensorBoard's profiler plugin and Perfetto (ui.perfetto.dev) open it.

The port also records spans and counters at the boundaries of its layers
(the predictor's queues, the layers' stages, the training step's parts,
the kernel wrappers), while any ``torch.profiler`` session runs, whatever
its activities, and only then:

- :func:`span` times a block on the host clock (``time.time_ns()``, the
  clock of Kineto's ``trace_start_ns()``); with ``device``, also on the
  card, through a pair of timing events on the device's current stream,
  resolved when the spans are read, so that the host never waits for them;
- :func:`mark` records a span begun on one thread and ended on another
  (the time an item spent in a queue);
- :func:`count` records a counter sample.

Each span keeps the innermost span open on its thread when it began (its
``parent``) and a ``key`` shared across threads: a predict batch's
ordinal, a training step's index, an item's ordinal in its queue. A span
without a key takes its parent's. With no profiler running a span costs
one module attribute read and records nothing. The spans are not
``record_function`` ranges: they add no host operator to a trace and leave
the profiler's launch correlation as it is. :func:`trace` writes the spans
of its block into its trace file, one track a thread.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

CAPACITY = 1 << 20  # records kept; past that they are dropped and counted


class Span(NamedTuple):
    """A recorded span. ``thread`` is None for a :func:`mark`; ``device_ms``
    is None unless the span was timed on a card."""

    name: str
    key: Any
    thread: Optional[int]
    parent: Optional[int]
    start_ns: int
    end_ns: int
    device_ms: Optional[float]
    id: int


class Count(NamedTuple):
    name: str
    key: Any
    thread: int
    t_ns: int
    value: float


class _Recorder:
    """The bounded buffer of spans and counter samples, shared by the
    process's threads."""

    def __init__(self, capacity: int = CAPACITY):
        self.capacity = capacity
        self.spans: List[list] = []  # Span fields; device_ms may be an event pair
        self.counts: List[Count] = []
        self.dropped = 0
        self.threads: Dict[int, str] = {}
        self.ids = itertools.count(1)
        self.local = threading.local()
        self.lock = threading.Lock()

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            thread = threading.current_thread()
            with self.lock:
                self.threads[thread.ident] = thread.name
            return self.local.stack

    def add(self, into: list, record) -> None:
        with self.lock:
            if len(self.spans) + len(self.counts) < self.capacity:
                into.append(record)
            else:
                self.dropped += 1

    def read_spans(self) -> List[Span]:
        with self.lock:
            for rec in self.spans:
                if isinstance(rec[6], tuple):  # resolve the card's timing once
                    start, end = rec[6]
                    end.synchronize()
                    rec[6] = start.elapsed_time(end)
            return [Span(*rec) for rec in self.spans]

    def clear(self) -> None:
        with self.lock:
            self.spans, self.counts, self.dropped = [], [], 0


_RECORDER = _Recorder()


class _Off:
    """The shared context of a span while no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "key", "stream", "id", "parent", "start_ns", "events")

    def __init__(self, name, key, stream):
        self.name, self.key, self.stream = name, key, stream

    def __enter__(self):
        stack = _RECORDER.stack()
        parent = stack[-1] if stack else None
        self.parent = parent.id if parent is not None else None
        if self.key is None and parent is not None:
            self.key = parent.key
        self.id = next(_RECORDER.ids)
        stack.append(self)
        self.events = None
        self.start_ns = time.time_ns()
        if self.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.events is not None:
            self.events[1].record(self.stream)
        end_ns = time.time_ns()
        stack = _RECORDER.stack()
        if self in stack:
            stack.remove(self)
        _RECORDER.add(_RECORDER.spans, [self.name, self.key, threading.get_ident(), self.parent,
                                        self.start_ns, end_ns, self.events, self.id])
        return False


def _stream(device):
    """The current stream of ``device``, or None where it is not a card."""
    if device is None:
        return None
    device = torch.device(device)
    return torch.cuda.current_stream(device) if device.type == "cuda" else None


def recording() -> bool:
    """Whether spans are recorded: a ``torch.profiler`` session runs."""
    return _autograd_profiler._is_profiler_enabled


def span(name: str, key=None, device=None):
    """A context manager that records the block as the span ``name`` while
    a profiler runs. ``device``: a CUDA device whose current stream also
    times the block, from the stream reaching the block's first work to
    its last (on a stream left idle, the card's wait for the host's
    launches counts too); a CPU device or None times it on the host
    alone."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, key, _stream(device))


def stamp() -> Optional[int]:
    """``time.time_ns()`` while spans are recorded, else None: the start of
    a :func:`mark` taken on another thread."""
    return time.time_ns() if _autograd_profiler._is_profiler_enabled else None


def mark(name: str, key, start_ns: Optional[int], end_ns: Optional[int] = None) -> None:
    """Record a span begun on one thread (``start_ns``, from :func:`stamp`)
    and ended on this one (``end_ns``, default now); nothing where
    ``start_ns`` is None or no profiler runs."""
    if start_ns is None or not _autograd_profiler._is_profiler_enabled:
        return
    end_ns = time.time_ns() if end_ns is None else end_ns
    _RECORDER.add(_RECORDER.spans,
                  [name, key, None, None, start_ns, end_ns, None, next(_RECORDER.ids)])


def count(name: str, value: float, key=None) -> None:
    """Record a counter sample while a profiler runs; ``key`` defaults to
    the innermost open span's."""
    if not _autograd_profiler._is_profiler_enabled:
        return
    stack = _RECORDER.stack()
    if key is None and stack:
        key = stack[-1].key
    _RECORDER.add(_RECORDER.counts,
                  Count(name, key, threading.get_ident(), time.time_ns(), value))


def spans() -> List[Span]:
    """The spans recorded, in the order they ended, with the card's times
    resolved (waiting for the card where they are not yet known)."""
    return _RECORDER.read_spans()


def counts() -> List[Count]:
    """The counter samples recorded, in order."""
    with _RECORDER.lock:
        return list(_RECORDER.counts)


def dropped() -> int:
    """Spans and samples dropped since the last :func:`clear`, the buffer
    being full."""
    return _RECORDER.dropped


def thread_names() -> Dict[int, str]:
    """The names of the threads that recorded spans, by thread id."""
    with _RECORDER.lock:
        return dict(_RECORDER.threads)


def clear() -> None:
    """Empty the buffer."""
    _RECORDER.clear()


def chrome_events(since_ns: int, base_ns: int) -> List[Dict]:
    """The spans and samples recorded from ``since_ns`` on, as Chrome trace
    events whose ``ts`` (us) counts from ``base_ns``: a span on its
    thread's track, a mark as an async slice, a sample as a counter."""
    pid, names = f"sleap-nn-torch spans ({os.getpid()})", thread_names()
    events: List[Dict] = [{"ph": "M", "name": "process_name", "pid": pid,
                           "args": {"name": pid}}]
    events += [{"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "args": {"name": name}} for tid, name in names.items()]
    for s in spans():
        if s.start_ns < since_ns:
            continue
        args = {"key": s.key, "id": s.id, "parent": s.parent}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        ts, dur = (s.start_ns - base_ns) / 1e3, (s.end_ns - s.start_ns) / 1e3
        if s.thread is None:
            common = {"cat": "sleap-nn-torch queue", "name": s.name, "pid": pid, "tid": 0,
                      "id": s.id}
            events += [dict(common, ph="b", ts=ts, args=args), dict(common, ph="e", ts=ts + dur)]
        else:
            events.append({"ph": "X", "cat": "sleap-nn-torch span", "name": s.name, "pid": pid,
                           "tid": s.thread, "ts": ts, "dur": dur, "args": args})
    events += [{"ph": "C", "name": c.name, "pid": pid, "ts": (c.t_ns - base_ns) / 1e3,
                "args": {"value": c.value}} for c in counts() if c.t_ns >= since_ns]
    return events


_EVENTS_KEY = '"traceEvents"'
_BASE_KEY = '"baseTimeNanoseconds"'


def add_spans_to_trace(path, since_ns: int) -> None:
    """Write the spans recorded from ``since_ns`` on into the Chrome trace
    file ``path`` (Kineto's), on its time base: the events go at the head
    of its ``traceEvents``, and the rest of the file is copied as it is."""
    path = Path(path)
    with open(path) as f:
        head = f.read(1 << 20)
        at = head.find(_EVENTS_KEY)
        if at < 0:
            return
        bracket = head.index("[", at) + 1
        base = 0
        b = head.find(_BASE_KEY, 0, at)
        if b >= 0:
            digits = head[head.index(":", b) + 1:at].strip().split(",")[0]
            base = int(digits.strip() or 0)
        events = chrome_events(since_ns, base)
        rest = head[bracket:]
        empty = rest.lstrip().startswith("]")
        tmp = path.with_name(path.name + ".tmp")
        with open(tmp, "w") as out:
            out.write(head[:bracket])
            out.write(",\n".join(json.dumps(ev) for ev in events))
            out.write("\n" if empty else ",\n")
            out.write(rest)
            shutil.copyfileobj(f, out)
    os.replace(tmp, path)


@contextlib.contextmanager
def trace(trace_dir, device=None):
    """Profile the block into ``trace_dir``; CUDA activity is recorded when
    ``device`` is a CUDA device (or None and a card is present). The
    port's spans of the block go into the same file, and then out of the
    recorder."""
    device = torch.device(device) if device is not None else None
    cuda = (device.type == "cuda") if device is not None else torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    before = set(trace_files(trace_dir))
    since_ns = time.time_ns()
    try:
        with torch.profiler.profile(
                activities=activities,
                on_trace_ready=torch.profiler.tensorboard_trace_handler(str(trace_dir))) as prof:
            try:
                yield prof
            finally:
                if cuda:
                    # The block's last kernels finish inside the trace:
                    # CUPTI records a kernel once it completes, and a block
                    # may end with work still queued (a training's last
                    # epoch-end viz).
                    torch.cuda.synchronize(device)
    finally:
        for path in trace_files(trace_dir):
            if path not in before:
                add_spans_to_trace(path, since_ns)
        clear()


def trace_files(trace_dir):
    """The trace files written into ``trace_dir``, oldest first."""
    return sorted(Path(trace_dir).glob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)
