"""Share of the traced stretch of a training window in which no kernel,
copy or set runs on the card: one less the union of the device intervals
over the stretch's length."""


def read(out, ctx):
    trace = out.trace
    if trace is None or trace.window_s <= 0 or not trace.device:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
