"""Median ms a batch that the predictor's main thread spends in
``predict.enqueue`` (the port's span around its replicas' enqueue: the
copies to the card, the layer's launches, the copies back), over the
batches of the traced run's device-only stretch."""

from portbench.core.port_spans import median_per_key


def read(out, ctx):
    return median_per_key(out, "predict.enqueue")
