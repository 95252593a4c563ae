"""The fused double-conv kernel's share of its roofline in the traced
run's stretch that records host operators (``kernel_trace``): the least time its calls could take (each call's operations at
the bf16 or float32 peak, or its bytes at the HBM rate, whichever is
larger; ``counts/fused_conv.py``, from the call's shape) over the device
time of the kernels those calls launched themselves, linked to the
benchmark's span around each call through the profiler's launch
correlation. Each call's bound counts once."""

from portbench.counts.fused_conv import call_bound_s, parse_span


def read(out, ctx):
    trace = out.record.get("kernel_trace")
    if trace is None:
        return None
    calls, busy_us = {}, 0.0
    for span, start, _, dur_us in trace.launched:
        shape = parse_span(span)
        if shape is not None:
            calls[(span, start)] = call_bound_s(*shape)
            busy_us += dur_us
    bound_s = sum(calls.values())
    if busy_us <= 0:
        return None
    return 100.0 * bound_s / (busy_us / 1e6)
