"""Median ms a batch spends ready but neither worked on by the host nor
computed by the card: its time in the provider's queue
(``provider.queued``) and from the end of its enqueue until the fetch
thread holds its outputs (``predict.in_flight``), less the card's time on
it (``predict.enqueue``'s device ms), over the batches of the traced run's
device-only stretch that have all three."""

from portbench.core.port_spans import device_ms, median, per_key, recorded


def read(out, ctx):
    got = recorded(out)
    if got is None:
        return None
    spans = got[0]
    queued = per_key(spans, "provider.queued")
    flight = per_key(spans, "predict.in_flight")
    card = per_key(spans, "predict.enqueue", device_ms)
    return median(queued[k] + flight[k] - card[k] for k in queued.keys() & flight.keys() & card.keys())
