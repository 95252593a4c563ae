"""Port parity: the training monitors (ZMQ events and commands, viz PNGs,
the offline wandb run) and the profiler traces, against the JAX trainer.

The JAX trainer and the port's are built from one centroid config and the
same in-memory labels (64x64 frames, UNet filters 8, max_stride 8, as
``tests/test_torch_training.py``), the port holding the JAX initial
params, with every monitor on: a ZMQ publisher whose events a SUB socket
bound here receives, a controller that a PUB socket bound here drives
(``set_lr`` at epoch 0's first batch, ``stop`` at epoch 1's first batch:
3 steps), ``visualize_preds_during_training`` with ``keep_viz`` and
``use_wandb`` (no ``wandb`` package: the local run directory). Each
trainer runs alone against the same sockets. The events, in order, and
their keys must be equal, with logs within the trainer parity tolerance
(1e-5 relative; the times apart); both stop at the same batch; the
learning rate after ``set_lr`` and the parameters after the run agree
(1e-5 absolute). The viz files are named alike per epoch and the points
drawn agree to 1e-4; the local wandb runs hold the same keys and values.
A profiler trace from the trainer and from ``run.predict(profile_dir=)``
is a Chrome trace that parses and holds events.
"""

import json
import socket
import time

import jax
import numpy as np
import pytest
import torch

from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.parallel import replicate
from sleap_nn_tpu.training import ModelTrainer as JTrainer
from sleap_nn_tpu.training import viz as jviz
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.parallel import distributed as pdist
from sleap_nn_tpu_torch.training import ModelTrainer
from sleap_nn_tpu_torch.training import viz as pviz
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_model_dir import frames_and_labels
from tests.test_torch_pipeline import cfg_dict
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

zmq = pytest.importorskip("zmq")

NEW_LR = 3e-3
TIMES = ("train/steps_per_sec", "train/samples_per_sec", "epoch_time_s")


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class Sockets:
    """The GUI's side: a SUB bound for the events, a PUB bound for the commands."""

    def __init__(self):
        self.ctx = zmq.Context()
        self.pub_port, self.ctl_port = _free_port(), _free_port()
        self.events = self.ctx.socket(zmq.SUB)
        self.events.subscribe("")
        self.events.bind(f"tcp://127.0.0.1:{self.pub_port}")
        self.commands = self.ctx.socket(zmq.PUB)
        self.commands.bind(f"tcp://127.0.0.1:{self.ctl_port}")

    def received(self):
        out = []
        while self.events.poll(200, zmq.POLLIN):
            out.append(json.loads(self.events.recv_string()))
        return out

    def close(self):
        for s in (self.events, self.commands):
            s.setsockopt(zmq.LINGER, 0)
            s.close()
        self.ctx.term()


class Commander:
    """A callback that sends the test's commands at batch starts."""

    def __init__(self, sock, plan):
        self.sock, self.plan = sock, plan

    def on_batch_start(self, trainer, batch_idx):
        msg = self.plan.get((trainer.current_epoch, batch_idx))
        if msg is not None:
            self.sock.commands.send_string(json.dumps(msg))

    def __getattr__(self, name):  # the other hooks do nothing
        if name.startswith("on_"):
            return lambda *a, **k: None
        raise AttributeError(name)


def make_labels(io):
    """Blob-frame labels whose video the model dir's ``.slp`` splits can name."""
    return frames_and_labels(io, 2)[1]


PLAN = {(0, 0): {"command": "set_lr", "lr": NEW_LR}, (1, 0): {"command": "stop"}}


def _config(sock, tmp_path, run, **extra):
    return cfg_dict(batch=4, max_epochs=3, train_steps_per_epoch=2, save_ckpt=True,
                    ckpt_dir=str(tmp_path), run_name=run,
                    zmq={"publish_port": sock.pub_port, "controller_port": sock.ctl_port,
                         "controller_polling_timeout": 500},
                    visualize_preds_during_training=True, keep_viz=True, use_wandb=True,
                    **extra)


def _run(trainer, sock, plan=PLAN):
    trainer.setup()
    trainer.callbacks.append(Commander(sock, plan))
    # A ZMQ socket handles its connection and subscription only when it is
    # used: pump both ends of both links before the first message.
    controllers = [cb.socket for cb in trainer.callbacks if hasattr(cb, "timeout")]
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < 1.0:
        for s in [sock.events] + controllers:
            s.poll(10)
    history = trainer.train()
    return history, sock.received()


def _without_end(events):
    """The events before a last ``train_end``: the publisher closes without
    lingering right after sending it (as in the JAX package), so it may not
    arrive."""
    names = [ev["event"] for ev in events]
    assert "train_end" not in names[:-1]
    return events[:-1] if names and names[-1] == "train_end" else events


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trainer's run, then the port's, with the points each drew."""
    tmp = tmp_path_factory.mktemp("monitors")
    sock = Sockets()
    drawn = {"jax": [], "port": []}

    def recorder(module, key):
        original = module.render_prediction_png

        def record(image, confmaps=None, peaks=None, gt_points=None, output_path=None,
                   **kw):
            drawn[key].append((output_path.name, np.asarray(peaks), np.asarray(gt_points)))
            return original(image, confmaps=confmaps, peaks=peaks, gt_points=gt_points,
                            output_path=output_path, **kw)

        return record

    mp = pytest.MonkeyPatch()
    mp.setattr(jviz, "render_prediction_png", recorder(jviz, "jax"))
    mp.setattr(pviz, "render_prediction_png", recorder(pviz, "port"))
    try:
        jt = JTrainer.get_model_trainer_from_config(
            JConfig.from_dict(_config(sock, tmp, "jax")), [make_labels(jio)])
        jt.setup()
        # The initial centroid maps are small and negative: flip and scale
        # the head so the viz finds peaks above its 0.1 threshold.
        init = jax.tree_util.tree_map_with_path(
            lambda path, v: v * -5 if "CentroidConfmapsHead" in jax.tree_util.keystr(path)
            and "kernel" in jax.tree_util.keystr(path) else v, jax.device_get(jt.params))
        jt.params = jax.device_put(init, replicate(jt.mesh))
        j_hist, j_events = _run(jt, sock)
        pt = ModelTrainer.get_model_trainer_from_config(
            PConfig.from_dict(_config(sock, tmp, "port")), [make_labels(pio)], device="cpu")
        pt.setup()
        pt.model.load_state_dict(flax_to_torch_state(init, pt.model), strict=True)
        p_hist, p_events = _run(pt, sock)
    finally:
        mp.undo()
        sock.close()
    return dict(jax=(jt, j_hist, j_events), port=(pt, p_hist, p_events), drawn=drawn)


def _shape(ev):
    return {k: v for k, v in ev.items() if k != "logs"}


def test_zmq_events_match_jax(runs):
    (_, _, j_events), (_, _, p_events) = runs["jax"], runs["port"]
    j_events, p_events = _without_end(j_events), _without_end(p_events)
    assert [ev["event"] for ev in p_events] == [ev["event"] for ev in j_events]
    assert [_shape(ev) for ev in p_events] == [_shape(ev) for ev in j_events]
    assert [ev["event"] for ev in p_events][:4] == ["train_begin", "epoch_begin",
                                                    "batch_start", "batch_end"]
    assert p_events[-1]["event"] == "epoch_end"
    for pe, je in zip(p_events, j_events):
        if je["logs"] is None:
            assert pe["logs"] is None
            continue
        assert set(pe["logs"]) == set(je["logs"])
        for k, v in je["logs"].items():
            if k not in TIMES:
                np.testing.assert_allclose(pe["logs"][k], v, rtol=1e-5, err_msg=k)


def test_stop_and_set_lr_match_jax(runs):
    (jt, j_hist, j_events), (pt, p_hist, p_events) = runs["jax"], runs["port"]
    ends = [(ev["epoch"], ev["batch"]) for ev in p_events if ev["event"] == "batch_end"]
    assert ends == [(0, 0), (0, 1), (1, 0)]  # stopped at epoch 1's first batch
    assert ends == [(ev["epoch"], ev["batch"]) for ev in j_events if ev["event"] == "batch_end"]
    assert len(p_hist) == len(j_hist) == 2
    assert p_hist[0]["learning_rate"] == j_hist[0]["learning_rate"] == pytest.approx(NEW_LR)
    assert pt.optimizer.param_groups[0]["lr"] == pytest.approx(NEW_LR)
    want = flax_to_torch_state(jax.device_get(jt.params), pt.model)
    for name, p in pt.model.state_dict().items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=1e-5, msg=name)


def test_viz_files_and_points_match_jax(runs):
    (jt, _, _), (pt, _, _) = runs["jax"], runs["port"]
    names = lambda t: sorted(p.name for p in (t.ckpt_dir / "viz").iterdir())  # noqa: E731
    assert names(pt) == names(jt) == ["epoch_0000.png", "epoch_0001.png"]
    drawn = runs["drawn"]
    assert [d[0] for d in drawn["port"]] == [d[0] for d in drawn["jax"]]
    n = 0
    for (_, pp, pg), (_, jp, jg) in zip(drawn["port"], drawn["jax"]):
        np.testing.assert_allclose(pg, jg, rtol=0, atol=1e-4)
        assert pp.shape == jp.shape
        np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-4)
        n += len(pp)
    assert n > 0  # peaks were drawn


def _local_run(trainer):
    runs = list((trainer.ckpt_dir / "wandb").glob("offline-run-*"))
    assert len(runs) == 1
    return runs[0]


def test_local_wandb_runs_match_jax(runs):
    (jt, _, _), (pt, _, _) = runs["jax"], runs["port"]
    jr, pr = _local_run(jt), _local_run(pt)
    assert sorted(p.name for p in pr.iterdir()) == sorted(p.name for p in jr.iterdir())
    jm = [json.loads(line) for line in (jr / "metrics.jsonl").read_text().splitlines()]
    pm = [json.loads(line) for line in (pr / "metrics.jsonl").read_text().splitlines()]
    assert len(pm) == len(jm) == 2
    for p, j in zip(pm, jm):
        assert set(p) == set(j)
        for k, v in j.items():
            if k not in TIMES:
                np.testing.assert_allclose(p[k], v, rtol=1e-5, err_msg=k)
    js, ps = (json.loads((r / "summary.json").read_text()) for r in (jr, pr))
    assert set(ps) == set(js) and ps["epochs"] == js["epochs"]
    np.testing.assert_allclose(ps["best_val_loss"], js["best_val_loss"], rtol=1e-5)
    assert set(json.loads((pr / "config.json").read_text())) == \
        set(json.loads((jr / "config.json").read_text()))
    assert pt.config.trainer_config.wandb.current_run_id == pr.name[len("offline-run-"):]


def test_viz_is_removed_unless_kept(tmp_path):
    d = cfg_dict(batch=4, max_epochs=1, train_steps_per_epoch=1, save_ckpt=True,
                 ckpt_dir=str(tmp_path), run_name="run", visualize_preds_during_training=True)
    pt = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [make_labels(pio)],
                                                    device="cpu")
    pt.train()
    assert pt.ckpt_dir.exists() and not (pt.ckpt_dir / "viz").exists()


def _trace_events(trace_dir):
    from sleap_nn_tpu_torch.profiling import trace_files

    files = trace_files(trace_dir)
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    return [ev for ev in events if ev.get("ph") == "X"]


def test_trainer_writes_a_profiler_trace(tmp_path, capsys):
    d = cfg_dict(batch=4, max_epochs=1, train_steps_per_epoch=2, save_ckpt=True,
                 ckpt_dir=str(tmp_path), run_name="run", profiler="pytorch")
    pt = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [make_labels(pio)],
                                                    device="cpu")
    pt.train()
    names = {ev["name"] for ev in _trace_events(pt.ckpt_dir / "profile")}
    assert any("conv" in n for n in names) and "Optimizer.step#Adam.step" in names


def test_predict_writes_a_profiler_trace(tmp_path):
    from sleap_nn_tpu_torch.inference import run as prun
    from tests.test_torch_model_dir import FrameVideo
    from tests.test_torch_topdown import blob_frames

    d = cfg_dict(batch=4, max_epochs=1, train_steps_per_epoch=1, save_ckpt=True,
                 ckpt_dir=str(tmp_path), run_name="centroid")
    pt = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [make_labels(pio)],
                                                    device="cpu")
    pt.train()
    frames = blob_frames(5, seed=1)
    video = FrameVideo(frames)
    labels = pio.Labels([pio.LabeledFrame(video, i) for i in range(5)])
    traced = prun.predict(labels, [pt.ckpt_dir], device="cpu", profile_dir=tmp_path / "prof")
    plain = prun.predict(labels, [pt.ckpt_dir], device="cpu")
    assert [len(lf) for lf in traced] == [len(lf) for lf in plain]
    names = {ev["name"] for ev in _trace_events(tmp_path / "prof")}
    assert any("conv" in n for n in names) and any("sort" in n for n in names)


def test_controller_commands_reach_every_rank(tmp_path, monkeypatch):
    """Two gloo ranks (the launcher spawns rank 1): rank 0's controller
    takes ``set_lr`` and ``stop``; both ranks stop at the same batch (a
    rank running on would wait at the next gradient all-reduce until the
    group timed out) and end as the one-process run of the same commands."""
    import datetime

    from sleap_nn_tpu_torch.training import model_trainer

    monkeypatch.setattr(pdist, "GROUP_TIMEOUT", datetime.timedelta(seconds=120))

    def train(devices, run):
        sock = Sockets()
        try:
            d = cfg_dict(batch=4, max_epochs=3, train_steps_per_epoch=2,
                         trainer_devices=devices, save_ckpt=True, ckpt_dir=str(tmp_path),
                         run_name=run, zmq={"controller_port": sock.ctl_port,
                                            "controller_polling_timeout": 500})
            trainer = ModelTrainer.get_model_trainer_from_config(
                PConfig.from_dict(d), [make_labels(pio)], device="cpu")
            history, _ = _run(trainer, sock)
        finally:
            sock.close()
        return trainer, history

    one, h1 = train(1, "one")
    monkeypatch.setattr(model_trainer, "available_devices", lambda device: 2)
    two, h2 = train(2, "two")
    assert (two.rank, two.n_ranks) == (0, 2) and not pdist.is_initialized()
    assert len(h1) == len(h2) == 2
    assert h1[0]["learning_rate"] == h2[0]["learning_rate"] == pytest.approx(NEW_LR)
    for k in ("train/loss", "val/loss"):
        np.testing.assert_allclose([h[k] for h in h2], [h[k] for h in h1], rtol=1e-5)
    state = one.model.state_dict()
    for name, p in two.model.state_dict().items():
        torch.testing.assert_close(p, state[name], rtol=0, atol=1e-5, msg=name)
