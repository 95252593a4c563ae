"""A profiler trace of a training or predict run, for TensorBoard and Perfetto.

Where the JAX package wraps a run in ``jax.profiler.trace(dir)``, the port
wraps it in :func:`trace`: ``torch.profiler`` records the host's operators
and, on a card, the CUDA kernels and copies (through CUPTI), and
``tensorboard_trace_handler`` writes one Chrome trace file,
``<worker>.<time>.pt.trace.json``, into the directory when the block ends.
TensorBoard's profiler plugin and Perfetto (ui.perfetto.dev) open it.
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(trace_dir, device=None):
    """Profile the block into ``trace_dir``; CUDA activity is recorded when
    ``device`` is a CUDA device (or None and a card is present)."""
    device = torch.device(device) if device is not None else None
    cuda = (device.type == "cuda") if device is not None else torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(trace_dir))) as prof:
        try:
            yield prof
        finally:
            if cuda:
                # The block's last kernels finish inside the trace: CUPTI
                # records a kernel once it completes, and a block may end
                # with work still queued (a training's last epoch-end viz).
                torch.cuda.synchronize(device)


def trace_files(trace_dir):
    """The trace files written into ``trace_dir``, oldest first."""
    return sorted(Path(trace_dir).glob("*.pt.trace.json"), key=lambda p: p.stat().st_mtime)
