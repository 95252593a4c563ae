"""The readers of the port's own spans and counters
(``core/port_spans.py`` and the five metrics that read it): on synthetic
records, the device-only stretch alone, and None with nothing recorded;
then on a tiny traced run of each cell on the CPU."""

import pytest

from portbench.core.run import Outcome, PKG, load_module, result
from portbench.core.trace import TraceData
from portbench.tests.tiny import tiny_ctx
from sleap_nn_tpu_torch import profiling
from sleap_nn_tpu_torch.profiling import Count, Span

T0 = 10**18
MS = 10**6


def reader(name):
    return load_module(PKG / "metrics" / f"{name}.py").read


def traced(window_s=3.0, lead_s=0.5):
    return Outcome(setup_s=1.0, trace=TraceData(window_s=window_s, lead_us=lead_s * 1e6))


def span(name, key, start_ms, host_ms, device_ms=None, thread=1):
    start = T0 + int(start_ms * MS)
    return Span(name, key, thread, None, start, start + int(host_ms * MS), device_ms, 0)


def predict_records(late_ms):
    """Batches 50 ms apart: enqueue 12 ms host / 25 ms device, queued 30 ms,
    in flight 100 ms; those from ``late_ms`` on ten times as long."""
    spans = []
    for key in range(80):
        t = 50.0 * key
        f = 10.0 if t >= late_ms else 1.0
        spans += [span("provider.queued", key, t, 30 * f, thread=None),
                  span("predict.enqueue", key, t + 30 * f, 12 * f, 25.0 * f),
                  span("topdown.centroid", key, t + 31 * f, 5 * f, 20.0 * f),
                  span("predict.in_flight", key, t + 42 * f, 100 * f, thread=None)]
    return spans


@pytest.fixture
def records(monkeypatch):
    def give(spans=(), counts=()):
        monkeypatch.setattr(profiling, "spans", lambda: list(spans))
        monkeypatch.setattr(profiling, "counts", lambda: list(counts))
    return give


def test_predict_readers_on_synthetic_batches(records):
    records(predict_records(late_ms=1e9))
    out = traced()
    assert reader("predict_enqueue_ms")(out, None) == pytest.approx(12.0)
    assert reader("predict_wait_ms")(out, None) == pytest.approx(30.0 + 100.0 - 25.0)
    assert reader("predict_centroid_device_ms")(out, None) == pytest.approx(20.0)


def test_the_host_operator_stretch_is_left_out(records):
    # Batches from 3.5 s on (the 0.5 s lead and 3 s window) read ten times longer.
    records(predict_records(late_ms=3550.0))
    out = traced(window_s=3.0, lead_s=0.5)
    assert reader("predict_enqueue_ms")(out, None) == pytest.approx(12.0)
    assert reader("predict_centroid_device_ms")(out, None) == pytest.approx(20.0)
    assert reader("predict_wait_ms")(out, None) == pytest.approx(105.0)


def test_a_batch_without_every_piece_is_left_out_of_the_wait(records):
    spans = predict_records(late_ms=1e9)
    spans = [s for s in spans if not (s.name == "predict.in_flight" and s.key % 2)]
    spans.append(span("predict.enqueue", 999, 10.0, 12.0, None))  # no device time
    records(spans)
    assert reader("predict_wait_ms")(traced(), None) == pytest.approx(105.0)
    assert reader("predict_enqueue_ms")(traced(), None) == pytest.approx(12.0)


def test_training_readers_on_synthetic_steps(records):
    spans = [span("train.backward", k, 230.0 * k, 3.0, 150.0 + k) for k in range(5)]
    spans.append(span("train.backward", 1, 240.0, 1.0, 10.0))  # a key's spans add up
    counts = [Count("loader.ready", k, 1, T0 + k * 230 * MS, v)
              for k, v in enumerate([0, 2, 2, 1, 2])]
    counts.append(Count("provider.ready", 0, 1, T0, 7))
    records(spans, counts)
    out = traced()
    assert reader("train_backward_device_ms")(out, None) == pytest.approx(153.0)
    assert reader("loader_ready_batches")(out, None) == pytest.approx(7 / 5)


NAMES = ["predict_enqueue_ms", "predict_wait_ms", "predict_centroid_device_ms",
         "train_backward_device_ms", "loader_ready_batches"]


@pytest.mark.parametrize("name", NAMES)
def test_none_with_nothing_to_read(records, monkeypatch, name):
    records()
    assert reader(name)(traced(), None) is None
    records(predict_records(1e9))
    assert reader(name)(Outcome(setup_s=1.0), None) is None  # no trace
    monkeypatch.delattr(profiling, "spans")  # a port without the recorder
    assert reader(name)(traced(), None) is None


@pytest.mark.parametrize("cell,found,silent", [
    ("topdown-predict-b8", ["predict_enqueue_ms"],
     ["predict_wait_ms", "predict_centroid_device_ms"]),
    ("bottomup-train-b4", ["loader_ready_batches"], ["train_backward_device_ms"]),
])
def test_a_traced_tiny_run_on_the_cpu(cell, found, silent):
    """The CPU has no device times: the host's spans and counters are read,
    the card's metrics are left out of the line."""
    profiling.clear()
    ctx, files = tiny_ctx(cell, seed=31, seconds=4.0, trace=True)
    # The trace from the step after the window opens to its end, so that a
    # slow CPU still takes a batch from the loader inside it.
    ctx.traffic.update(trace_start_s=0.0, trace_seconds=4.0)
    out = load_module(files["entry"]).run(ctx)
    line, _ = result(ctx, out, files["end_to_end"], files["per_layer"],
                     {"platform": "cpu", "kind": "cpu", "count": 1})
    profiling.clear()
    assert line["correct"], line["checks"]
    for name in found:
        assert line["metrics"][name]["value"] > 0 if name.endswith("_ms") else \
            line["metrics"][name]["value"] >= 0
    for name in silent:
        assert name not in line["metrics"]


def test_idle_by_span_places_each_gap_among_the_threads_spans():
    from portbench.tools.idle_by_span import batch_split, idle_tables

    data = TraceData(window_s=0.010, lead_us=1000.0,
                     device=[("k", 1000.0, 3000.0), ("k", 5000.0, 9000.0), ("k", 9500.0, 11000.0)])
    main, fetch = 1, 2
    spans = [span("train.backward", 0, 0.0, 4.5, thread=main),
             span("train.optimizer", 0, 4.5, 0.5, thread=main),
             span("kernel.x", 0, 2.5, 1.0, thread=main),
             span("loader.make", 1, 0.0, 10.0, thread=fetch),
             span("loader.queued", 1, 0.0, 10.0, thread=None)]
    spans = [s._replace(start_ns=s.start_ns - T0, end_ns=s.end_ns - T0) for s in spans]
    got = idle_tables(spans, {main: "MainThread", fetch: "loader"}, 0, data)
    # Gaps at 3-5 ms (mostly in the kernel span's 2.5-3.5, then backward
    # to 4.5) and 9-9.5 ms (nothing on the main thread).
    assert got["n_gaps"] == 2 and got["idle_ms"] == pytest.approx(2.5)
    rows = {r[0]: r for r in got["by_launcher"]}
    assert rows["train.backward"][2] == pytest.approx(2.0)
    assert rows["-"][2] == pytest.approx(0.5)
    assert "loader: loader.make" in got["longest"][0][1]
    assert batch_split(spans) is None
