"""Mean of the batches already waiting in the trainer's loader queue when
the training loop takes one (the port's counter ``loader.ready``, of a
queue two batches deep), over the traced run."""

from portbench.core.port_spans import recorded


def read(out, ctx):
    got = recorded(out)
    values = [c.value for c in got[1] if c.name == "loader.ready"] if got else []
    return sum(values) / len(values) if values else None
