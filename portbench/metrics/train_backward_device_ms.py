"""Median ms a step of the card's time in the trainer's ``train.backward``
(the loss's backward through the UNet and heads), timed by the port's
events on the stream, over the steps of the traced run."""

from portbench.core.port_spans import device_ms, median_per_key


def read(out, ctx):
    return median_per_key(out, "train.backward", device_ms)
