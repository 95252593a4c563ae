"""Port parity: data-parallel training (``parallel/`` and the trainer's DDP
path) against the JAX trainer on its device mesh.

The JAX trainer runs at ``trainer_devices: 2`` on the CPU's forced host
devices (``tests/conftest.py``): a 2-device ``data`` mesh over the global
batch. The port runs two gloo ranks, spawned on the CPU, each holding its
rows of every global batch: one joins through the JAX package's launch
variables (``SLEAP_NN_TPU_COORDINATOR`` / ``_NUM_PROCESSES`` /
``_PROCESS_ID``), the other group is made by the test before the trainer.
Both start from the JAX trainer's initial params and take 3 steps on the
first three global batches (the third padded), centroid without and
bottom-up with online hard keypoint mining. Tolerances as
``tests/test_torch_training.py``: losses 1e-5 relative, step-0 gradients
1e-4 of each tensor's largest magnitude, parameters after 3 steps 1e-5
absolute; the two ranks' parameters are equal exactly.

The launcher (no group, the port's device count monkeypatched to 2)
spawns rank 1 from the calling process; its run, with augmentation on,
must equal a single-process run of the same config, as each rank's
render of its rows must equal those rows of the global batch's render.
Every group here times out after 120 s (``distributed.GROUP_TIMEOUT``,
set in each process), so that a rank that fails cannot hang the others.
"""

import datetime

import math
import multiprocessing
import socket
from pathlib import Path

import numpy as np
import pytest
import torch

from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.parallel import distributed as pdist
from sleap_nn_tpu_torch.parallel import mesh as pmesh
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

OHKM = {"online_mining": True, "hard_to_easy_ratio": 1.05, "min_hard_keypoints": 1,
        "max_hard_keypoints": 2, "loss_scale": 5.0}


TIMEOUT = datetime.timedelta(seconds=120)


@pytest.fixture(autouse=True)
def _bounded_groups(monkeypatch):
    monkeypatch.setattr(pdist, "GROUP_TIMEOUT", TIMEOUT)


def _free_addr():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return f"localhost:{sock.getsockname()[1]}"


def _spawn(fn, n, *args):
    """Run ``fn(rank, *args)`` in ``n`` spawned processes; a rank that
    fails raises here."""
    torch.multiprocessing.start_processes(fn, args=args, nprocs=n, join=True,
                                          start_method="spawn")


# --- the parallel functions -------------------------------------------------------


def test_device_count_rule_matches_jax():
    for bs in (1, 2, 4, 6, 8):
        for vbs in (2, 3, 4, 8):
            for want in (None, "auto", 0, 1, 2, 3, 4, 8):
                for n_avail in (1, 2, 4, 8):
                    # sleap_nn_tpu/training/model_trainer.py:626-631
                    n = int(want) if isinstance(want, int) and want > 0 else n_avail
                    expect = math.gcd(math.gcd(bs, vbs), min(n, n_avail))
                    assert pmesh.num_devices(bs, vbs, want, n_avail) == expect
    assert pmesh.available_devices("cpu") == 1


@pytest.mark.parametrize("batch,n", [(4, 2), (8, 4), (6, 3), (4, 1)])
def test_shard_rows_are_the_mesh_shards(batch, n):
    """A rank's rows are those JAX's ``P("data")`` sharding gives its device."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sleap_nn_tpu.parallel import get_mesh

    x = np.arange(batch * 3).reshape(batch, 3)
    arr = jax.device_put(x, NamedSharding(get_mesh(num_devices=n), P("data")))
    for rank, dev in enumerate(get_mesh(num_devices=n).devices):
        shard = next(s for s in arr.addressable_shards if s.device == dev)
        np.testing.assert_array_equal(x[pmesh.shard_rows(batch, rank, n)], np.asarray(shard.data))
    with pytest.raises(ValueError, match="divide evenly"):
        pmesh.shard_rows(batch + 1, 0, 2 if batch % 2 == 0 else 4)


def test_single_process_functions_match_jax(monkeypatch):
    from sleap_nn_tpu.parallel import distributed as jdist

    for name in (pdist.ENV_COORDINATOR, pdist.ENV_NUM_PROCESSES, pdist.ENV_PROCESS_ID,
                 "MASTER_ADDR", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(name, raising=False)
    assert pdist.initialize_distributed() is False and not pdist.is_initialized()
    for pkg in (pdist, jdist):
        assert (pkg.process_count(), pkg.process_index(), pkg.is_multiprocess()) == (1, 0, False)
        assert pkg.local_batch_size(6) == 6
        pkg.barrier("x")
        pkg.sync_cache_fill_status(None)
        with pytest.raises(KeyError, match="boom"):
            pkg.sync_cache_fill_status(KeyError("boom"))
    t = torch.arange(3.0, requires_grad=True)
    assert torch.equal(pdist.all_reduce_sum(t), t.detach())
    assert pdist.broadcast_object({"a": 1}) == {"a": 1}
    # A launch contract that names some of its values and not the others.
    monkeypatch.setenv(pdist.ENV_COORDINATOR, "localhost:1")
    with pytest.raises(ValueError, match="number of processes, process id"):
        pdist.initialize_distributed()


def _rank_sync(rank, addr, out):
    pdist.GROUP_TIMEOUT = TIMEOUT
    pdist.initialize_distributed(addr, 2, rank, device="cpu")
    try:
        assert (pdist.process_count(), pdist.process_index(), pdist.is_multiprocess()) == \
            (2, rank, True)
        assert pdist.local_batch_size(4) == 2
        got = pdist.all_reduce_sum(torch.tensor([rank + 1.0]))
        name = pdist.broadcast_object(f"from {rank}")
        try:
            pdist.sync_cache_fill_status(OSError("disk full") if rank == 1 else None)
            raised = None
        except Exception as e:  # noqa: BLE001 (recorded for the parent)
            raised = f"{type(e).__name__}: {e}"
        pdist.barrier("end")
        torch.save({"sum": got.item(), "name": name, "raised": raised}, out / f"r{rank}.pt")
    finally:
        pdist.destroy()


def test_collectives_and_cache_fill_failure_raise_on_every_rank(tmp_path):
    _spawn(_rank_sync, 2, _free_addr(), tmp_path)
    r0, r1 = (torch.load(tmp_path / f"r{r}.pt") for r in range(2))
    assert r0["sum"] == r1["sum"] == 3.0 and r0["name"] == r1["name"] == "from 0"
    assert r1["raised"] == "OSError: disk full"
    assert r0["raised"].startswith("RuntimeError: Data-cache fill failed on process(es) [1]")


AUGMENT = {"geometric": {"rotation_max": 20.0, "rotation_p": 0.7, "flip_p": 0.5,
                         "erase_p": 0.5, "erase_scale_min": 0.05, "erase_scale_max": 0.1,
                         "mixup_p": 0.5, "mixup_lambda_min": 0.1, "mixup_lambda_max": 0.4},
           "intensity": {"uniform_noise_p": 0.5, "gaussian_noise_p": 0.5, "contrast_p": 0.5,
                         "brightness_p": 0.5}}


@pytest.mark.parametrize("n", [2, 4])
def test_each_rank_renders_its_rows_of_the_global_augmentation(n):
    """A rank loads only its rows of a global batch (and, for mixup, the
    row before them), draws the augmentation of the whole global batch and
    renders those rows: they equal the rows of one process's render."""
    from sleap_nn_tpu_torch.data.pipeline import Loader
    from sleap_nn_tpu_torch.io import model as pio
    from sleap_nn_tpu_torch.training import ModelTrainer
    from tests.test_torch_pipeline import cfg_dict, make_labels

    d = cfg_dict(augment=True, batch=4, model_type="bottomup")
    d["data_config"]["augmentation_config"] = AUGMENT
    pt = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [make_labels(pio)],
                                                    device="cpu")
    pt.setup()
    render = pt._renders[True]
    whole = next(iter(Loader(pt.train_ds, 4, shuffle=True, seed=3, prefetch=0)))
    want = render(pt._to_device(whole), torch.Generator().manual_seed(5))
    for rank in range(n):
        loader = Loader(pt.train_ds, 4, shuffle=True, seed=3, prefetch=0, rank=rank,
                        num_ranks=n, lead_row=True)
        own = pmesh.shard_rows(4, rank, n)
        assert list(loader.rows) == [(own.start - 1) % 4] + list(range(own.start, own.stop))
        part = next(iter(loader))
        got = render(pt._to_device(part), torch.Generator().manual_seed(5),
                     torch.as_tensor(loader.rows), 4)
        for k in ("image", "instances", "confmaps", "pafs"):
            torch.testing.assert_close(got[k][1:], want[k][own], rtol=0, atol=1e-6,
                                       equal_nan=True, msg=k)
        np.testing.assert_array_equal(part["batch_mask"][1:], whole["batch_mask"][own])


# --- two gloo ranks against the JAX trainer's 2-device mesh ---------------------


def _cfg(model_type, tmp_path):
    from tests.test_torch_pipeline import cfg_dict

    kw = {"online_hard_keypoint_mining": OHKM} if model_type == "bottomup" else {}
    d = cfg_dict(batch=4, model_type=model_type, trainer_devices=2, save_ckpt=True,
                 ckpt_dir=str(tmp_path), run_name="ddp", **kw)
    d["data_config"]["validation_fraction"] = 0.2  # 2 val frames: the val batch is padded
    return d


def _rank_train(rank, addr, out, cfg_d, init_state, joins_itself):
    import os

    from sleap_nn_tpu_torch.io import model as pio
    from sleap_nn_tpu_torch.training import ModelTrainer
    from tests.test_torch_pipeline import make_labels

    pdist.GROUP_TIMEOUT = TIMEOUT
    if joins_itself:  # the JAX package's launch variables; the trainer joins
        host, port = addr.split(":")
        os.environ.update({pdist.ENV_COORDINATOR: f"{host}:{port}",
                           pdist.ENV_NUM_PROCESSES: "2", pdist.ENV_PROCESS_ID: str(rank)})
    else:
        pdist.initialize_distributed(addr, 2, rank, device="cpu")
    writes = []
    real_save = torch.save

    def counting_save(obj, f, *a, **k):
        writes.append(str(f))
        return real_save(obj, f, *a, **k)

    try:
        pt = ModelTrainer.get_model_trainer_from_config(
            PConfig.from_dict(cfg_d), [make_labels(pio)], device="cpu")
        pio.Labels.save = (lambda save: lambda self, p, **k: (writes.append(str(p)),
                                                                save(self, p, **k))[1]
                           )(pio.Labels.save)
        torch.save = counting_save
        pt.setup()
        pt.model.load_state_dict(init_state, strict=True)
        batches = list(pt.train_loader._gen())[:3]
        losses, grads = [], None
        for batch in batches:
            losses.append(pt.train_step(batch)[0].item())
            if grads is None:
                grads = {n: p.grad.clone() for n, p in pt.model.named_parameters()}
        val = pt.val_step(next(iter(pt.val_loader)))
        pt.save_checkpoint("last.ckpt")
        torch.save = real_save
        real_save({"losses": losses, "grads": grads, "state": pt.model.state_dict(),
                   "batches": batches, "val": (val[0].item(), {k: v.item() for k, v in
                                                               val[1].items()}),
                   "writes": writes, "ckpt_dir": str(pt.ckpt_dir),
                   "ranks": (pt.rank, pt.n_ranks)}, out / f"rank{rank}.pt")
    finally:
        torch.save = real_save
        pdist.destroy()


@pytest.mark.parametrize("model_type,joins_itself", [("centroid", True), ("bottomup", False)],
                         ids=["centroid-launch-variables", "bottomup-ohkm-own-group"])
def test_two_gloo_ranks_match_the_jax_mesh(tmp_path, model_type, joins_itself):
    import jax
    import jax.numpy as jnp

    from sleap_nn_tpu.config import TrainingJobConfig as JConfig
    from sleap_nn_tpu.io import model as jio
    from sleap_nn_tpu.parallel import shard_batch as jshard
    from sleap_nn_tpu.training import ModelTrainer as JTrainer
    from sleap_nn_tpu_torch.models.model import Model
    from sleap_nn_tpu_torch.weights import flax_to_torch_state
    from tests.test_torch_pipeline import make_labels
    from tests.test_torch_training import _jax_grads

    cfg_d = _cfg(model_type, tmp_path / "port")
    jd = _cfg(model_type, tmp_path / "jax")
    jd["trainer_config"]["save_ckpt"] = False  # its .slp writer needs a real video
    jt = JTrainer.get_model_trainer_from_config(JConfig.from_dict(jd), [make_labels(jio)])
    jt.setup()
    assert jt.mesh.devices.size == 2
    from sleap_nn_tpu.config.base import to_dict as jto_dict

    pcfg = PConfig.from_dict(jto_dict(jt.config))  # part names and edges filled in
    head = getattr(pcfg.model_config.head_configs, model_type)
    holder = Model.from_config("unet", pcfg.model_config.backbone_config.unet, head, model_type)
    init_state = flax_to_torch_state(jax.device_get(jt.params), holder)
    _spawn(_rank_train, 2, _free_addr(), tmp_path, cfg_d, init_state, joins_itself)
    r0, r1 = (torch.load(tmp_path / f"rank{r}.pt", weights_only=False) for r in range(2))
    assert r0["ranks"] == (0, 2) and r1["ranks"] == (1, 2)

    # Each rank held its rows of JAX's global batches; the third is padded.
    jbatches = list(jt.train_loader._gen())[:3]
    assert not jbatches[-1]["batch_mask"].all()
    for jb, b0, b1 in zip(jbatches, r0["batches"], r1["batches"]):
        for k in ("image", "instances", "batch_mask"):
            np.testing.assert_array_equal(np.concatenate([b0[k], b1[k]]), jb[k])

    params, opt_state = jt.params, jt.tx.init(jt.params)
    copy = lambda t: jax.tree_util.tree_map(lambda x: x.copy(), t)  # noqa: E731 (donated)
    for step, batch in enumerate(jbatches):
        sharded = jshard(batch, jt.mesh)
        if step == 0:
            want_grads = flax_to_torch_state(
                jax.device_get(_jax_grads(jt, {k: jnp.asarray(v) for k, v in batch.items()})),
                holder)
        params, opt_state, want_loss, _ = jt._train_step(copy(params), copy(opt_state),
                                                         sharded, jax.random.PRNGKey(step))
        for r in (r0, r1):
            np.testing.assert_allclose(r["losses"][step], float(want_loss), rtol=1e-5)
    if model_type == "centroid":  # _jax_grads renders without OHKM
        for name, g in r0["grads"].items():
            scale = want_grads[name].abs().max().item()
            assert (g - want_grads[name]).abs().max().item() <= 1e-4 * scale, name
    want = flax_to_torch_state(jax.device_get(params), holder)
    for name, p in r0["state"].items():
        torch.testing.assert_close(p, want[name], rtol=0, atol=1e-5, msg=name)
        assert torch.equal(p, r1["state"][name]), name
    vbatch = next(iter(jt.val_loader))
    want_val, want_vparts = jt._val_step(params, jshard(vbatch, jt.mesh))
    for r in (r0, r1):
        np.testing.assert_allclose(r["val"][0], float(want_val), rtol=1e-5)
        for k, v in want_vparts.items():
            np.testing.assert_allclose(r["val"][1][k], float(v), rtol=1e-5, atol=1e-7, err_msg=k)

    # Rank 0 alone wrote the model dir; both ranks name it.
    assert r0["ckpt_dir"] == r1["ckpt_dir"] == str(tmp_path / "port" / "ddp")
    assert r1["writes"] == []
    assert {Path(w).name for w in r0["writes"]} == {
        "labels_train_gt_0.slp", "labels_val_gt_0.slp", "last.ckpt.tmp"}
    files = {p.name for p in (tmp_path / "port" / "ddp").iterdir()}
    assert {"training_config.yaml", "initial_config.yaml", "last.ckpt"} <= files


# --- the launcher ------------------------------------------------------------------


def test_launcher_spawns_the_other_rank_and_matches_one_process(tmp_path, monkeypatch):
    from sleap_nn_tpu_torch.io import model as pio
    from sleap_nn_tpu_torch.train import run_training
    from sleap_nn_tpu_torch.training import model_trainer
    from tests.test_torch_pipeline import cfg_dict, make_labels

    def cfg(devices, run):
        d = cfg_dict(augment=True, batch=4, trainer_devices=devices, max_epochs=2,
                     train_steps_per_epoch=2, save_ckpt=devices > 1, ckpt_dir=str(tmp_path),
                     run_name=run)
        d["data_config"]["augmentation_config"] = AUGMENT
        return PConfig.from_dict(d)

    one = run_training(cfg(1, "one"), [make_labels(pio)], device="cpu")
    assert one.n_ranks == 1 and not one.distributed
    monkeypatch.setattr(model_trainer, "available_devices", lambda device: 2)
    two = run_training(cfg(2, "two"), [make_labels(pio)], device="cpu")
    # Rank 0 loaded its rows of each global batch and the row before them.
    assert (two.rank, two.n_ranks) == (0, 2) and list(two.train_loader.rows) == [3, 0, 1]
    assert not multiprocessing.active_children() and not pdist.is_initialized()
    assert len(two.history) == len(one.history) == 2
    for h1, h2 in zip(one.history, two.history):
        for k in ("train/loss", "val/loss", "val/confmap_loss_fg"):
            np.testing.assert_allclose(h2[k], h1[k], rtol=1e-5, err_msg=k)
        assert h2["train/samples_per_sec"] / h2["train/steps_per_sec"] == pytest.approx(
            h1["train/samples_per_sec"] / h1["train/steps_per_sec"])
    state1 = one.model.state_dict()
    for name, p in two.model.state_dict().items():
        torch.testing.assert_close(p, state1[name], rtol=0, atol=1e-5, msg=name)
    run = tmp_path / "two"
    rows = (run / "training_log.csv").read_text().strip().splitlines()
    assert len(rows) == 3  # rank 0's log alone: a header and one row an epoch
    assert {"best.ckpt", "labels_pr.val_0.slp", "metrics.val.0.npz"} <= {
        p.name for p in run.iterdir()}


def test_file_backed_labels_pickle_into_the_ranks(tmp_path):
    """The launcher pickles the labels into its ranks: a video file's and an
    embedded ``.slp``'s backends leave their per-thread handles behind and
    read again where they are unpickled."""
    import pickle

    import cv2

    from sleap_nn_tpu_torch.io import model as pio
    from sleap_nn_tpu_torch.io.slp import load_slp
    from sleap_nn_tpu_torch.io.video import Video
    from tests.test_torch_pipeline import make_labels

    frames = np.random.default_rng(0).integers(0, 256, (3, 32, 48, 3), dtype=np.uint8)
    writer = cv2.VideoWriter(str(tmp_path / "clip.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10,
                             (48, 32))
    for f in frames:
        writer.write(f)
    writer.release()
    video = Video.from_filename(str(tmp_path / "clip.avi"))
    first = video[1]
    assert np.array_equal(pickle.loads(pickle.dumps(video))[1], first)
    make_labels(pio, n_frames=3).save(tmp_path / "emb.slp", embed=True)
    labels = load_slp(tmp_path / "emb.slp")
    lf = labels.labeled_frames[2]
    want = lf.video[lf.frame_idx]
    again = pickle.loads(pickle.dumps(labels)).labeled_frames[2]
    assert np.array_equal(again.video[again.frame_idx], want)
