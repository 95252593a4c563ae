"""The port's spans and counters (``sleap_nn_tpu_torch/profiling.py``), on
the CPU: nothing is recorded while no profiler runs; under one, spans nest,
share their keys across threads, sit on the profiler's clock and go into
``profiling.trace()``'s file; a top-down predict and a bottom-up training
step record the spans of their layers."""

import json
import sys
import threading
from types import SimpleNamespace as ns

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sleap_nn_tpu_torch import profiling


@pytest.fixture(autouse=True)
def empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def test_off_records_nothing_and_reads_no_clock(monkeypatch):
    def refused(*a, **k):
        raise AssertionError("called with no profiler running")

    with monkeypatch.context() as m:
        m.setattr(profiling.time, "time_ns", refused)
        m.setattr(torch.cuda, "Event", refused)
        assert not profiling.recording()
        assert profiling.span("a") is profiling.span("b", key=1, device="cuda")
        with profiling.span("a", key=1, device="cpu") as sp:
            assert sp is None
            profiling.count("c", 1.0)
            profiling.mark("m", 1, profiling.stamp())
        assert profiling.stamp() is None
    assert profiling.spans() == [] and profiling.counts() == [] and profiling.dropped() == 0


def test_spans_nest_under_a_profiler_and_keys_pass_to_children():
    with cpu_profile():
        assert profiling.recording()
        with profiling.span("outer", key=4) as outer:
            with profiling.span("inner") as inner:
                with profiling.span("innermost", key=9):
                    profiling.count("depth", 3.0)
            with profiling.span("sibling"):
                pass
        profiling.mark("queued", 4, profiling.stamp())
    by = {s.name: s for s in profiling.spans()}
    assert by["outer"].parent is None and by["outer"].key == 4
    assert by["inner"].parent == outer.id and by["inner"].key == 4
    assert by["innermost"].parent == inner.id and by["innermost"].key == 9
    assert by["sibling"].parent == outer.id
    assert by["queued"].thread is None and by["queued"].key == 4
    assert by["outer"].start_ns <= by["inner"].start_ns <= by["inner"].end_ns <= by["outer"].end_ns
    assert all(s.device_ms is None for s in by.values())
    (c,) = profiling.counts()
    assert (c.name, c.key, c.value) == ("depth", 9, 3.0)
    assert profiling.thread_names()[threading.get_ident()] == threading.current_thread().name


def test_the_buffer_drops_and_counts_past_its_bound(monkeypatch):
    monkeypatch.setattr(profiling._RECORDER, "capacity", 5)
    with cpu_profile():
        for i in range(4):
            with profiling.span("s", key=i):
                pass
        for i in range(3):
            profiling.count("c", i)
    assert len(profiling.spans()) == 4 and len(profiling.counts()) == 1
    assert profiling.dropped() == 2
    profiling.clear()
    assert profiling.spans() == [] and profiling.dropped() == 0


def test_threads_recording_at_once_lose_no_record(monkeypatch):
    """More threads than cores record into a bounded buffer, with a short
    switch interval: every span is either kept or counted as dropped."""
    monkeypatch.setattr(profiling._RECORDER, "capacity", 3000)
    n_threads, per_thread = 16, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with cpu_profile():
            def work(t):
                for i in range(per_thread):
                    with profiling.span("outer", key=(t, i)):
                        with profiling.span("inner"):
                            pass

            threads = [threading.Thread(target=work, args=(t,)) for t in range(n_threads)]
            for th in threads:
                th.start()
            for th in threads:
                th.join(timeout=60)
            assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(interval)
    got = profiling.spans()
    assert len(got) == 3000 and len(got) + profiling.dropped() == 2 * n_threads * per_thread
    ids = {s.id: s for s in got}
    assert len(ids) == len(got)
    for s in got:  # a parent is a span of the same thread and key
        if s.name == "inner" and s.parent in ids:
            assert ids[s.parent].thread == s.thread and ids[s.parent].key == s.key


def test_spans_share_the_profilers_clock():
    a = torch.randn(256, 256)
    with cpu_profile() as prof:
        with profiling.span("around_mm"):
            torch.mm(a, a)
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    (sp,) = profiling.spans()
    mm = [ev for ev in prof.events() if ev.name == "aten::mm"]
    assert len(mm) == 1
    assert (sp.start_ns - start_ns) / 1e3 <= mm[0].time_range.start
    assert mm[0].time_range.end <= (sp.end_ns - start_ns) / 1e3


def test_trace_writes_the_spans_into_its_file(tmp_path):
    a = torch.randn(64, 64)
    with profiling.trace(tmp_path, "cpu"):
        with profiling.span("traced", key=2):
            with profiling.span("child"):
                torch.mm(a, a)
        profiling.mark("queued", 2, profiling.stamp())
        profiling.count("depth", 1.0, key=2)
    (path,) = profiling.trace_files(tmp_path)
    events = json.loads(path.read_text())["traceEvents"]
    ours = {ev["name"]: ev for ev in events if ev.get("cat", "").startswith("sleap-nn-torch")}
    assert ours["traced"]["ph"] == "X" and ours["traced"]["args"]["key"] == 2
    assert ours["child"]["args"]["parent"] == ours["traced"]["args"]["id"]
    assert ours["queued"]["ph"] in ("b", "e")
    assert any(ev.get("ph") == "C" and ev["name"] == "depth" for ev in events)
    mm = [ev for ev in events if ev.get("name") == "aten::mm"][0]
    child = ours["child"]
    assert child["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= child["ts"] + child["dur"] + 1e-3
    assert profiling.spans() == []  # the block's spans left the recorder with the file


# -- the layers' spans ---------------------------------------------------------


def _unet_model(head, model_type):
    from sleap_nn_tpu_torch.config.model_config import UNetConfig
    from sleap_nn_tpu_torch.models.model import Model

    ucfg = UNetConfig(in_channels=1, filters=4, filters_rate=1.5, max_stride=8, output_stride=2)
    torch.manual_seed(0)
    return Model.from_config("unet", ucfg, head, model_type).eval()


def tiny_topdown_layer():
    from sleap_nn_tpu_torch.inference.backends import TorchBackend
    from sleap_nn_tpu_torch.inference.layers import (
        CenteredInstanceLayer, CentroidLayer, PostprocessConfig, PreprocessConfig, TopDownLayer)

    centroid = _unet_model(ns(confmaps=ns(anchor_part=None, sigma=2.0, output_stride=2,
                                          loss_weight=None)), "centroid")
    instance = _unet_model(ns(confmaps=ns(part_names=["a", "b"], anchor_part=None, sigma=2.0,
                                          output_stride=2, loss_weight=None)),
                           "centered_instance")
    pre = PreprocessConfig(ensure_grayscale=True, max_stride=8)
    c_layer = CentroidLayer(TorchBackend(centroid, None, fused_convs=True, device="cpu"), pre,
                            PostprocessConfig(peak_threshold=0.0, max_instances=2),
                            output_stride=2, device="cpu")
    i_layer = CenteredInstanceLayer(TorchBackend(instance, None, fused_convs=True, device="cpu"), pre,
                                    PostprocessConfig(peak_threshold=0.0), output_stride=2,
                                    device="cpu")
    return TopDownLayer(c_layer, i_layer, max_instances=2, crop_size=16, device="cpu")


class NoiseVideo:
    def __init__(self, n, hw=32):
        self.frames = np.random.default_rng(0).integers(0, 256, (n, hw, hw, 1), dtype=np.uint8)
        self.shape = self.frames.shape

    def __len__(self):
        return len(self.frames)

    def get_frame(self, idx, fmt=None):
        return self.frames[idx]


PREDICT_CHAIN = ["provider.make", "provider.queued", "predict.enqueue", "predict.in_flight",
                 "predict.postprocess", "predict.emit"]


def test_topdown_predict_records_each_batchs_spans_under_its_key():
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import VideoProvider

    n_batches = 3
    predictor = Predictor(tiny_topdown_layer(), "topdown", batch_size=2, device="cpu")
    with cpu_profile():
        results = predictor.predict(provider=VideoProvider(NoiseVideo(2 * n_batches),
                                                           batch_size=2), make_labels=False)
    assert len(results) == n_batches
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    for key in range(n_batches):
        mine = {}
        for s in spans:
            if s.key == key:
                mine.setdefault(s.name, []).append(s)
        chain = [mine[name] for name in PREDICT_CHAIN]
        assert all(len(c) == 1 for c in chain), {n: len(c) for n, c in zip(PREDICT_CHAIN, chain)}
        chain = [c[0] for c in chain]
        for a, b in zip(chain, chain[1:]):  # in that order, one after another
            assert a.start_ns <= a.end_ns <= b.start_ns, (a.name, b.name)
        enqueue = chain[2]
        stages = [mine[name][0] for name in ("topdown.centroid", "topdown.crops",
                                             "topdown.instance")]
        for a, b in zip(stages, stages[1:]):
            assert a.end_ns <= b.start_ns
        assert all(s.parent == enqueue.id and s.thread == enqueue.thread for s in stages)
        # The kernel wrappers' spans sit inside the stages.
        convs = mine["kernel.fused_double_conv3x3"]
        assert convs and all(by_id[s.parent].name in ("topdown.centroid", "topdown.instance")
                             for s in convs)
        assert mine["provider.wait"][0].thread == enqueue.thread
        assert mine["provider.make"][0].thread != enqueue.thread
        assert mine["predict.emit"][0].thread not in (None, enqueue.thread)
    pending = [c for c in profiling.counts() if c.name == "predict.pending"]
    assert [c.key for c in pending] == list(range(n_batches))
    assert all(0 <= c.value <= c.key for c in pending)
    ready = [c for c in profiling.counts() if c.name == "provider.ready"]
    assert len(ready) == n_batches + 1 and all(0 <= c.value <= 2 for c in ready)


class ArrayVideo:
    def __init__(self, frames):
        self.frames = frames
        self.shape = frames.shape

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, i):
        return self.frames[i]

    def get_frame(self, i, fmt=None):
        return self.frames[i]


def tiny_bottomup_trainer(steps):
    from sleap_nn_tpu_torch.config import TrainingJobConfig
    from sleap_nn_tpu_torch.io.model import Instance, LabeledFrame, Labels, Skeleton
    from sleap_nn_tpu_torch.training.model_trainer import ModelTrainer

    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (6, 32, 32, 1), dtype=np.uint8)
    skel = Skeleton(["a", "b", "c"], edges=[(0, 1), (1, 2)])
    video = ArrayVideo(frames)
    lfs = [LabeledFrame(video, f, [Instance(rng.uniform(6, 26, (3, 2)), skel)])
           for f in range(len(frames))]
    cfg = TrainingJobConfig.from_dict({
        "data_config": {"preprocessing": {"max_height": 32, "max_width": 32}},
        "model_config": {
            "backbone_config": {"unet": {"filters": 4, "filters_rate": 1.5, "max_stride": 8,
                                         "output_stride": 2}},
            "head_configs": {"bottomup": {"confmaps": {"sigma": 2.0, "output_stride": 2},
                                          "pafs": {"sigma": 4.0, "output_stride": 2}}}},
        "trainer_config": {"max_epochs": 1, "train_steps_per_epoch": steps, "seed": 1,
                           "save_ckpt": False, "enable_progress_bar": False,
                           "train_data_loader": {"batch_size": 2},
                           "val_data_loader": {"batch_size": 2}},
    })
    return ModelTrainer.get_model_trainer_from_config(cfg, [Labels(lfs[:4])], [Labels(lfs[4:])],
                                                      device="cpu")


TRAIN_STAGES = ["train.to_device", "train.render", "train.forward_loss", "train.backward",
                "train.optimizer"]


def test_bottomup_training_records_the_steps_and_the_loaders_spans():
    steps = 3
    trainer = tiny_bottomup_trainer(steps)
    with cpu_profile():
        trainer.train()
    assert trainer.steps_taken == steps
    spans = profiling.spans()
    for key in range(steps):
        stages = [[s for s in spans if s.name == name and s.key == key] for name in TRAIN_STAGES]
        assert all(len(s) == 1 for s in stages), [len(s) for s in stages]
        stages = [s[0] for s in stages]
        for a, b in zip(stages, stages[1:]):
            assert a.end_ns <= b.start_ns and a.thread == b.thread
        assert all(s.parent is None and s.device_ms is None for s in stages)
    names = {s.name for s in spans}
    assert {"loader.make", "loader.queued", "loader.wait"} <= names
    assert "kernel.make_multi_confmaps" in names
    ready = [c for c in profiling.counts() if c.name == "loader.ready"]
    assert ready and all(0 <= c.value <= 2 for c in ready)
    # The loader's spans run on its own thread, its waits on the trainer's.
    make = [s for s in spans if s.name == "loader.make"]
    wait = [s for s in spans if s.name == "loader.wait"]
    assert {s.thread for s in make}.isdisjoint({s.thread for s in wait})
    assert {s.thread for s in wait} == {stages[0].thread}


def test_an_unprofiled_predict_records_nothing():
    from sleap_nn_tpu_torch.inference.predictor import Predictor
    from sleap_nn_tpu_torch.inference.providers import VideoProvider

    predictor = Predictor(tiny_topdown_layer(), "topdown", batch_size=2, device="cpu")
    results = predictor.predict(provider=VideoProvider(NoiseVideo(4), batch_size=2),
                                make_labels=False)
    assert len(results) == 2
    assert profiling.spans() == [] and profiling.counts() == []
