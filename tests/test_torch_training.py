"""Port parity: centroid training (``training/`` and ``train.py``) against the
JAX package.

Module tests feed both packages numpy-made inputs. The slice test builds
the JAX ``ModelTrainer`` and the port's from one config and the same
in-memory labels (64x64 frames, UNet filters 8, max_stride 8, augmentation
off), carries the JAX initial params into the port with ``weights.py``
and runs 3 train steps of each on the same batches. Tolerances: losses
1e-5 relative (f32 sums in another order); gradients 1e-4 of each tensor's
largest magnitude (f32 convolutions and their transposes summed in
another order); parameters after 3 Adam steps 1e-5 absolute (each step
moves a weight by at most about the learning rate, 1e-4).
"""

import csv
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.models import heads as jheads
from sleap_nn_tpu.training import ModelTrainer as JTrainer
from sleap_nn_tpu.training import callbacks as jcb
from sleap_nn_tpu.training import losses as jl
from sleap_nn_tpu.training import schedulers as js
from sleap_nn_tpu.training.model_trainer import xavier_init_params as jxavier
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.models import heads as pheads
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.train import run_training
from sleap_nn_tpu_torch.training import ModelTrainer, xavier_init_params
from sleap_nn_tpu_torch.training.model_trainer import make_optimizer
from sleap_nn_tpu_torch.training import callbacks as pcb
from sleap_nn_tpu_torch.training import losses as pl
from sleap_nn_tpu_torch.training import schedulers as ps
from sleap_nn_tpu_torch.weights import flax_path_for, flax_to_torch_state
from tests.test_torch_pipeline import cfg_dict, make_labels


def _t(x):
    return torch.from_numpy(np.array(x))


# --- config -----------------------------------------------------------------


def test_config_schema_round_trips_like_jax(tmp_path):
    from sleap_nn_tpu.config import apply_overrides as japply
    from sleap_nn_tpu.config.base import to_dict as jto_dict
    from sleap_nn_tpu_torch.config import apply_overrides as papply, to_dict as pto_dict

    d = cfg_dict(augment=True, anchor="n1", lr_scheduler={"step_lr": {"step_size": 2}})
    jc, pc = JConfig.from_dict(d), PConfig.from_dict(d)
    assert pto_dict(pc) == jto_dict(jc)
    over = {"trainer_config.optimizer.lr": "1e-05", "model_config.backbone_config.unet.filters": 16,
            "data_config.preprocessing.scale": "0.5"}
    japply(jc, over)
    papply(pc, over)
    assert pto_dict(pc) == jto_dict(jc) and pc.trainer_config.optimizer.lr == 1e-5
    with pytest.raises(AttributeError):
        papply(pc, {"trainer_config.no_such_field": 1})
    pc.save_yaml(tmp_path / "cfg.yaml")
    assert jto_dict(JConfig.load_yaml(tmp_path / "cfg.yaml")) == \
        pto_dict(PConfig.load_yaml(tmp_path / "cfg.yaml")) == {**pto_dict(pc),
                                                               "filename": str(tmp_path / "cfg.yaml")}


@pytest.mark.parametrize("section,bad", [
    ("trainer_config", {"max_epochs": 0}),
    ("data_config", {"negative_loss_weight": 0.0}),
    ("data_config", {"augmentation_config": {"geometric": {"flip_p": 1.5}}}),
    ("data_config", {"preprocessing": {"scale": -1.0}}),
])
def test_verify_training_cfg_rejects_like_jax(section, bad):
    from sleap_nn_tpu.config import verify_training_cfg as jverify
    from sleap_nn_tpu_torch.config import verify_training_cfg as pverify

    d = cfg_dict()
    d[section] = {**d[section], **bad}
    with pytest.raises(ValueError):
        jverify(JConfig.from_dict(d))
    with pytest.raises(ValueError):
        pverify(PConfig.from_dict(d))


# --- losses -----------------------------------------------------------------


def _maps(shape, seed):
    rng = np.random.default_rng(seed)
    gt = np.clip(rng.random(shape, dtype=np.float32) * 1.4 - 0.4, 0, 1).astype(np.float32)
    pr = (gt + 0.3 * rng.standard_normal(shape)).astype(np.float32)
    return gt, pr


@pytest.mark.parametrize("mask", [None, [True, True, False], [False, False, False]])
def test_mse_loss_matches(mask):
    gt, pr = _maps((3, 8, 10, 2), 0)
    m = None if mask is None else np.asarray(mask)
    want = jl.mse_loss(jnp.asarray(pr), jnp.asarray(gt), None if m is None else jnp.asarray(m))
    got = pl.mse_loss(_t(pr), _t(gt), None if m is None else _t(m))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("kw", [dict(), dict(hard_to_easy_ratio=1.1, min_hard_keypoints=1),
                                dict(max_hard_keypoints=2, loss_scale=2.0)])
def test_ohkm_loss_matches(kw):
    gt, pr = _maps((2, 6, 6, 5), 1)
    pr[..., 3] += 0.5  # one hard channel
    want = jl.compute_ohkm_loss(jnp.asarray(gt), jnp.asarray(pr), **kw)
    got = pl.compute_ohkm_loss(_t(gt), _t(pr), **kw)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def test_other_losses_match():
    gt, pr = _maps((2, 6, 7, 1), 2)
    logits = (pr * 4 - 2).astype(np.float32)
    for pw in (None, 3.0):
        np.testing.assert_allclose(
            pl.compute_bce_dice_loss(_t(logits), _t(gt), pos_weight=pw).item(),
            float(jl.compute_bce_dice_loss(jnp.asarray(logits), jnp.asarray(gt), pos_weight=pw)),
            rtol=1e-5)
        probs = 1 / (1 + np.exp(-logits))
        np.testing.assert_allclose(
            pl.bce_dice_on_probs(_t(probs), _t(gt), pos_weight=pw).item(),
            float(jl.bce_dice_on_probs(jnp.asarray(probs), jnp.asarray(gt), pos_weight=pw)),
            rtol=1e-5)
    mask = (gt > 0.5).astype(np.float32)
    for m in (mask, np.zeros_like(mask)):
        np.testing.assert_allclose(
            pl.compute_masked_smooth_l1(_t(pr * 3), _t(gt), _t(m)).item(),
            float(jl.compute_masked_smooth_l1(jnp.asarray(pr * 3), jnp.asarray(gt),
                                              jnp.asarray(m))), rtol=1e-5, atol=1e-12)
    rng = np.random.default_rng(3)
    probs = rng.dirichlet(np.ones(4), 5).astype(np.float32)
    onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 5)]
    onehot[2] = 0  # an untracked row
    np.testing.assert_allclose(
        pl.categorical_crossentropy(_t(probs), _t(onehot)).item(),
        float(jl.categorical_crossentropy(jnp.asarray(probs), jnp.asarray(onehot))), rtol=1e-5)


@pytest.mark.parametrize("ohkm", [None, {"online_mining": True, "hard_to_easy_ratio": 1.5,
                                          "min_hard_keypoints": 1, "max_hard_keypoints": None,
                                          "loss_scale": 5.0}])
@pytest.mark.parametrize("head", ["centroid", "multi", "single", "bottomup"])
def test_compute_loss_and_diagnostics_match(head, ohkm):
    c = 1 if head == "centroid" else 3
    gt, pr = _maps((3, 8, 8, c), 4)
    names = ("a", "b", "c")
    if head == "centroid":
        jh, ph = [jheads.CentroidConfmapsHead(output_stride=2)], [pheads.CentroidConfmapsHead(
            output_stride=2)]
    elif head == "single":
        jh = [jheads.SingleInstanceConfmapsHead(part_names=names, loss_weight=2.0)]
        ph = [pheads.SingleInstanceConfmapsHead(part_names=names, loss_weight=2.0)]
    else:
        jh = [jheads.MultiInstanceConfmapsHead(part_names=names, loss_weight=0.5)]
        ph = [pheads.MultiInstanceConfmapsHead(part_names=names, loss_weight=0.5)]
    preds, targets = {jh[0].name: pr}, {"confmaps": gt}
    if head == "bottomup":  # confmaps and PAFs, each at its own weight
        edges = (("a", "b"), ("b", "c"))
        jh.append(jheads.PartAffinityFieldsHead(edges=edges, loss_weight=3.0))
        ph.append(pheads.PartAffinityFieldsHead(edges=edges, loss_weight=3.0))
        gt_p, pr_p = _maps((3, 4, 4, 4), 5)
        preds[jh[1].name], targets["pafs"] = pr_p * 2 - 1, gt_p * 2 - 1
    mask = np.asarray([True, False, True])
    want, wparts = jl.compute_loss({k: jnp.asarray(v) for k, v in preds.items()},
                                   {k: jnp.asarray(v) for k, v in targets.items()},
                                   jh, jnp.asarray(mask), ohkm)
    got, gparts = pl.compute_loss({k: _t(v) for k, v in preds.items()},
                                  {k: _t(v) for k, v in targets.items()}, ph, _t(mask), ohkm)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert set(gparts) == set(wparts) == {h.name for h in jh} | {
        "confmap_loss_fg", "confmap_loss_bg", "confmap_fg_frac"}
    for k in wparts:
        np.testing.assert_allclose(gparts[k].item(), float(wparts[k]), rtol=1e-5, err_msg=k)


# --- schedulers and callbacks ----------------------------------------------


SCHEDULES = [
    None,
    {"step_lr": {"step_size": 3, "gamma": 0.5}},
    {"reduce_lr_on_plateau": {"threshold": 1e-3, "threshold_mode": "rel", "cooldown": 1,
                              "patience": 1, "factor": 0.3, "min_lr": 1e-6}},
    {"reduce_lr_on_plateau": {"patience": 0, "cooldown": 0, "min_lr": [1e-5]}},
    {"cosine_annealing_warmup": {"warmup_epochs": 3, "warmup_start_lr": 1e-5, "eta_min": 1e-6}},
    {"linear_warmup_linear_decay": {"warmup_epochs": 2, "max_epochs": 8, "end_lr": 1e-6}},
]


@pytest.mark.parametrize("sched", SCHEDULES, ids=lambda s: next(iter(s)) if s else "none")
def test_schedulers_match(sched):
    d = {"trainer_config": {"lr_scheduler": sched, "max_epochs": 10}}
    jcfg = JConfig.from_dict(d).trainer_config
    pcfg = PConfig.from_dict(d).trainer_config
    a = js.make_scheduler(jcfg.lr_scheduler, 1e-3, 10)
    b = ps.make_scheduler(pcfg.lr_scheduler, 1e-3, 10)
    vals = [1.0, 0.9, 0.9, 0.95, 0.8, 0.8, 0.8, 0.8, 0.7, 0.7, 0.71, 0.72]
    assert [a.step(e + 1, v) for e, v in enumerate(vals)] == \
        [b.step(e + 1, v) for e, v in enumerate(vals)]


def test_callbacks_match(tmp_path):
    logs = [{"train/loss": 1.0 / (e + 1), "val/loss": [0.5, 0.4, 0.45, 0.41, 0.42, 0.43][e],
             **({"val/mOKS": 0.3} if e == 2 else {})} for e in range(6)]
    trainers = [types.SimpleNamespace(should_stop=False) for _ in range(2)]
    cbs = [[jcb.CSVLoggerCallback(tmp_path / "j.csv"), jcb.EarlyStopping(patience=2)],
           [pcb.CSVLoggerCallback(tmp_path / "p.csv"), pcb.EarlyStopping(patience=2)]]
    stops = [[], []]
    for side in range(2):
        for e, lg in enumerate(logs):
            for cb in cbs[side]:
                cb.on_epoch_end(trainers[side], e, lg)
            stops[side].append(trainers[side].should_stop)
    assert stops[0] == stops[1] and stops[0][-1] and not stops[0][2]
    assert (tmp_path / "j.csv").read_text() == (tmp_path / "p.csv").read_text()


def test_progress_callback_line(capsys):
    cb = pcb.ProgressCallback()
    cb.on_epoch_start(None, 0)
    cb.on_epoch_end(None, 0, {"val/loss": 0.123456, "name": "x"})
    out = capsys.readouterr().out
    assert out.startswith("Epoch 0: val/loss=0.12346 (") and "name" not in out


# --- Xavier init --------------------------------------------------------------


def test_xavier_init_uses_the_jax_fans():
    d = cfg_dict()
    d["model_config"]["backbone_config"]["unet"]["up_interpolate"] = False  # trans convs too
    cfg = PConfig.from_dict(d)
    model = Model.from_config("unet", cfg.model_config.backbone_config.unet,
                              cfg.model_config.head_configs.centroid, "centroid")
    xavier_init_params(model, torch.Generator().manual_seed(0))
    # The JAX rule on the flax tree of the same architecture (shapes only).
    from sleap_nn_tpu.models.model import Model as FlaxModel

    jcfg = JConfig.from_dict(d)
    fmodel = FlaxModel.from_config("unet", jcfg.model_config.backbone_config.unet,
                                   jcfg.model_config.head_configs.centroid, "centroid")
    shapes = jax.eval_shape(fmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 1)))
    fparams = jxavier(jax.tree_util.tree_map(lambda a: np.zeros(a.shape, a.dtype), shapes),
                      jax.random.PRNGKey(1))
    leaves = {tuple(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_leaves_with_path(fparams["params"])}
    n_trans = 0
    for key, value in model.state_dict().items():
        path, kind = flax_path_for(key)
        leaf = leaves[path]
        if kind == "bias":
            assert (value == 0).all() and (leaf == 0).all(), key
            continue
        n_trans += kind == "trans_conv_kernel"
        limit = math.sqrt(6.0 / (np.prod(leaf.shape[:-1]) + leaf.shape[-1]))
        assert value.abs().max().item() <= limit and np.abs(leaf).max() <= limit, key
        if value.numel() >= 200:  # the draws reach toward the bound and fill it uniformly
            assert value.abs().max().item() > 0.9 * limit, key
            assert abs(value.std().item() - limit / math.sqrt(3)) < 0.15 * limit, key
    assert n_trans > 0


# --- the slice: the JAX trainer against the port's ------------------------


@pytest.fixture(scope="module")
def jax_trainer():
    """One JAX trainer for the module: its setup (eager flax init and probe
    render) is the slow part of these tests."""
    jt = JTrainer.get_model_trainer_from_config(JConfig.from_dict(cfg_dict(batch=4)),
                                                [make_labels(jio)])
    jt.setup()
    return jt


def _port_trainer(jt, **trainer_kw):
    """The port's trainer on the same config and labels, holding ``jt``'s params."""
    pt = ModelTrainer.get_model_trainer_from_config(
        PConfig.from_dict(cfg_dict(batch=4, **trainer_kw)), [make_labels(pio)], device="cpu")
    pt.setup()
    pt.model.load_state_dict(flax_to_torch_state(jax.device_get(jt.params), pt.model),
                             strict=True)
    return pt


def _jax_grads(jt, batch):
    from sleap_nn_tpu.data.pipeline import make_render_fn

    render = make_render_fn(jt.ctx, train=True)

    def loss_fn(params):
        processed = render(batch, None)
        preds = jt.model.apply(params, processed["image"])
        w = batch["batch_mask"].astype(jnp.float32) * batch["sample_weight"]
        return jl.compute_loss(preds, processed, jt.model.heads, w, None)[0]

    return jax.jit(jax.grad(loss_fn))(jt.params)


def test_trainer_steps_match_jax(jax_trainer):
    jt = jax_trainer
    pt = _port_trainer(jt)
    assert [lf.frame_idx for lf in jt.train_labels[0]] == [lf.frame_idx for lf in pt.train_labels[0]]
    assert pt._input_shape == tuple(jt._input_shape)
    batches = list(jt.train_loader._gen())[:3]
    assert len(batches) == 3 and not batches[-1]["batch_mask"].all()  # a padded batch
    params, opt_state = jt.params, jt.tx.init(jt.params)
    copy = lambda t: jax.tree_util.tree_map(lambda x: x.copy(), t)  # noqa: E731 (donated)
    for step, batch in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if step == 0:
            want_grads = flax_to_torch_state(jax.device_get(_jax_grads(jt, jbatch)), pt.model)
        params, opt_state, want_loss, _ = jt._train_step(copy(params), copy(opt_state), jbatch,
                                                         jax.random.PRNGKey(step))
        got_loss, _ = pt.train_step(batch)
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
        if step == 0:
            for name, p in pt.model.named_parameters():
                scale = want_grads[name].abs().max().item()
                err = (p.grad - want_grads[name]).abs().max().item()
                assert err <= 1e-4 * scale, (name, err, scale)
    want_params = flax_to_torch_state(jax.device_get(params), pt.model)
    for name, p in pt.model.state_dict().items():
        torch.testing.assert_close(p, want_params[name], rtol=0, atol=1e-5, msg=name)
    vbatch = next(iter(jt.val_loader))
    want_val, want_vparts = jt._val_step(params, {k: jnp.asarray(v) for k, v in vbatch.items()})
    got_val, got_vparts = pt.val_step(vbatch)
    np.testing.assert_allclose(got_val.item(), float(want_val), rtol=1e-5)
    assert set(got_vparts) == set(want_vparts)


@pytest.mark.parametrize("name", ["adam", "adamw"])
def test_optimizers_match_optax(name):
    """Three steps of the port's optimizer against optax's on the same gradients."""
    import optax

    rng = np.random.default_rng(0)
    p0 = rng.standard_normal((4, 5)).astype(np.float32)
    grads = [rng.standard_normal((4, 5)).astype(np.float32) * 10.0 ** -k for k in range(3)]
    tx = {"adam": optax.adam, "adamw": optax.adamw}[name](1e-3)
    jp, state = jnp.asarray(p0), None
    state = tx.init(jp)
    param = torch.nn.Parameter(_t(p0))
    opt = make_optimizer([param], name, 1e-3)
    for g in grads:
        updates, state = tx.update(jnp.asarray(g), state, jp)
        jp = optax.apply_updates(jp, updates)
        param.grad = _t(g)
        opt.step()
    np.testing.assert_allclose(param.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-6)


def test_history_keys_match_jax(jax_trainer):
    jt = jax_trainer
    pt = _port_trainer(jt, max_epochs=1, train_steps_per_epoch=1)
    jt.config.trainer_config.max_epochs = 1
    jt.config.trainer_config.train_steps_per_epoch = 1
    jh, ph = jt.train(), pt.train()
    assert len(jh) == len(ph) == 1 and set(jh[0]) == set(ph[0])
    for k in ("train/loss", "val/loss", "val/confmap_loss_fg"):
        np.testing.assert_allclose(ph[0][k], jh[0][k], rtol=1e-5, err_msg=k)


def test_train_on_cpu_writes_the_model_dir(tmp_path):
    d = cfg_dict(save_ckpt=True, ckpt_dir=str(tmp_path), run_name="run",
                 model_ckpt={"save_last": True})
    d["data_config"]["use_augmentations_train"] = True
    d["data_config"]["augmentation_config"] = {"geometric": {}, "intensity": {"brightness_p": 0.5}}
    trainer = run_training(PConfig.from_dict(d), [make_labels(pio)], device="cpu")
    hist = trainer.history
    assert len(hist) == 2 and all(np.isfinite(h["train/loss"]) for h in hist)
    run = tmp_path / "run"
    assert trainer.ckpt_dir == run
    rows = list(csv.DictReader(open(run / "training_log.csv")))
    assert [r["epoch"] for r in rows] == ["0", "1"] and "val/loss" in rows[0]
    state = torch.load(run / "best.ckpt", weights_only=True)
    assert set(state) == {"state_dict", "epoch", "best_val_loss"}
    assert all(k.startswith("model.") for k in state["state_dict"])
    assert state["best_val_loss"] == min(h["val/loss"] for h in hist)
    fresh = Model.from_config("unet", trainer.config.model_config.backbone_config.unet,
                              trainer.config.model_config.head_configs.centroid, "centroid")
    fresh.load_state_dict(ModelTrainer.load_checkpoint_params(run / "best.ckpt"), strict=True)
    assert (run / "last.ckpt").exists()
    # A second run into the same name gets a suffixed directory.
    again = run_training(PConfig.from_dict(d), [make_labels(pio)], device="cpu")
    assert again.ckpt_dir == tmp_path / "run-1"


@pytest.mark.parametrize("override", [
    {"model_config": {"head_configs": {"centroid": None, "bottomup_segmentation": {}}}},
    {"trainer_config": {"resume_ckpt_path": "x.ckpt"}},
    {"trainer_config": {"use_wandb": True}},
    {"trainer_config": {"zmq": {"publish_port": 9001}}},
    {"trainer_config": {"optimizer": {"amsgrad": True}}},
    {"trainer_config": {"trainer_devices": 2}},
    {"trainer_config": {"visualize_preds_during_training": True}},
    {"data_config": {"use_negative_frames": True}},
    {"data_config": {"preprocessing": {"tiling": {"enabled": True, "tile_size": 32}}}},
    {"model_config": {"pretrained_backbone_weights": "a/b"}},
], ids=lambda o: next(iter(next(iter(o.values())))))
def test_unported_features_raise(override):
    d = cfg_dict()
    for section, val in override.items():
        d[section] = {**d[section], **val}
    with pytest.raises(NotImplementedError):
        ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [make_labels(pio)],
                                                   device="cpu")


def test_labels_from_paths_and_cuda_without_card_raise(monkeypatch):
    with pytest.raises(NotImplementedError, match="in-memory"):
        run_training(PConfig.from_dict(cfg_dict()), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(cfg_dict()),
                                                   [make_labels(pio)])
