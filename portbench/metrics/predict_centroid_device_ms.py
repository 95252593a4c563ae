"""Median ms a batch of the card's time in the top-down layer's
``topdown.centroid`` stage (preprocess, centroid UNet, local peaks and
top-K), timed by the port's events on the stream, over the batches of the
traced run's device-only stretch."""

from portbench.core.port_spans import device_ms, median_per_key


def read(out, ctx):
    return median_per_key(out, "topdown.centroid", device_ms)
