"""Port parity: the trainer options of ``training/model_trainer.py`` and
``data/pipeline.py`` against the JAX trainer, on the CPU.

- Resume: parameters (bit for bit), ``epoch + 1`` and the best val loss
  come from the checkpoint, the optimizer restarts, and the next steps
  agree with the JAX trainer's resumed from the same weights; the
  seed-mismatch and missing-config warnings and the shape ``ValueError``
  read as the JAX trainer's.
- Transfer init: the backbone or the heads from another model dir, the
  JAX errors for a missing subtree and for other shapes, and the refusal
  of a JAX orbax checkpoint.
- ``init_weights`` other than default / xavier: flax's initialisers, held
  by distribution (per tensor: standard deviation within 10% of the JAX
  trainer's, every value within two of the LeCun standard deviations,
  zero biases).
- ``save_top_k``: the epoch-stamped file names and the pruning.
- Negative frames: samples exact, then 3 steps from the same parameters
  with losses to 1e-5 relative and parameters to 1e-5 absolute.
- User centroids: samples exact, centroid targets to 1e-6, both
  ``ValueError``s.
- AMSGrad: 3 steps against ``optax.amsgrad`` to 1e-5; AdamW with AMSGrad
  raises the JAX ``ValueError``.
"""

import copy
import re
import shutil
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.config import get_head_config as jhead_config
from sleap_nn_tpu.data import pipeline as jpipe
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.training import ModelTrainer as JTrainer
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.config import get_head_config as phead_config
from sleap_nn_tpu_torch.data import pipeline as ppipe
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.models.model import param_subtree
from sleap_nn_tpu_torch.training import ModelTrainer
from sleap_nn_tpu_torch.training.model_trainer import AMSGrad, make_optimizer
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_model_dir import FrameVideo, blob_frames
from tests.test_torch_pipeline import cfg_dict
from tests.test_torch_train_files import _three_steps
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

HW, N = 64, 12


def _labels(io, n=N, seed=3, negatives=(), user_centroids=()):
    """1-3 three-node instances a frame; frames in ``negatives`` are empty,
    frames in ``user_centroids`` carry one or two user centroids and no
    instance."""
    rng = np.random.default_rng(seed)
    video = FrameVideo(blob_frames(n, seed=4))
    skel = io.Skeleton(["n0", "n1", "n2"], edges=[(0, 1), (1, 2)])
    lfs = []
    for f in range(n):
        pts = [rng.uniform(12, HW - 12, 2) + rng.normal(0, 4, (3, 2))
               for _ in range(int(rng.integers(1, 4)))]
        cents = [rng.uniform(8, HW - 8, 2) for _ in range(1 + f % 2)]
        if f in negatives:
            lfs.append(io.LabeledFrame(video, f, []))
        elif f in user_centroids:
            lfs.append(io.LabeledFrame(video, f, [], centroids=[io.UserCentroid(c)
                                                                 for c in cents]))
        else:
            lfs.append(io.LabeledFrame(video, f, [io.Instance(p, skel) for p in pts]))
    return io.Labels(lfs, videos=[video], skeletons=[skel])


def _cfgs(d, **labels_kw):
    return ((JConfig.from_dict(copy.deepcopy(d)), _labels(jio, **labels_kw)),
            (PConfig.from_dict(copy.deepcopy(d)), _labels(pio, **labels_kw)))


def _trainers(d, **labels_kw):
    (jc, jl), (pc, pl) = _cfgs(d, **labels_kw)
    return (JTrainer.get_model_trainer_from_config(jc, [jl]),
            ModelTrainer.get_model_trainer_from_config(pc, [pl], device="cpu"))


def _d(model_type="centroid", **trainer):
    return cfg_dict(model_type=model_type, batch=2, **trainer)


def _train_dir(root, model_type="centroid", filters=8, seed=7, package="port", **trainer):
    """Train 1 epoch of 1 step into ``root/<run>`` in one package."""
    d = _d(model_type, max_epochs=1, train_steps_per_epoch=1, save_ckpt=True,
           ckpt_dir=str(root), run_name=f"{package}_{model_type}_{filters}", seed=seed,
           **trainer)
    d["model_config"]["backbone_config"]["unet"]["filters"] = filters
    if package == "port":
        t = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [_labels(pio)],
                                                       device="cpu")
    else:
        t = JTrainer.get_model_trainer_from_config(JConfig.from_dict(d), [_labels(jio)])
    t.train()
    return t.ckpt_dir


# --- resume --------------------------------------------------------------------


def _port_ckpt_from_jax(jdir, pdir, model):
    """A port model dir holding the JAX checkpoint's weights, epoch and best
    val loss, beside a copy of its training config."""
    state = JTrainer.load_checkpoint_params(jdir / "best.ckpt")
    pdir.mkdir(parents=True)
    shutil.copy(jdir / "training_config.yaml", pdir / "training_config.yaml")
    sd = flax_to_torch_state(jax.device_get(state["params"]), model)
    torch.save({"state_dict": {f"model.{k}": v for k, v in sd.items()},
                "epoch": int(state["epoch"]), "best_val_loss": float(state["best_val_loss"])},
               pdir / "best.ckpt")
    return state


def test_resume_matches_jax(tmp_path):
    jdir = _train_dir(tmp_path, package="jax")
    d = _d(max_epochs=3, train_steps_per_epoch=3)
    d["trainer_config"]["resume_ckpt_path"] = str(jdir / "best.ckpt")
    jt = JTrainer.get_model_trainer_from_config(JConfig.from_dict(copy.deepcopy(d)),
                                                [_labels(jio)])
    probe = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(_d()), [_labels(pio)],
                                                       device="cpu")
    probe.setup()
    state = _port_ckpt_from_jax(jdir, tmp_path / "port_run", probe.model)
    d["trainer_config"]["resume_ckpt_path"] = str(tmp_path / "port_run" / "best.ckpt")
    pt = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [_labels(pio)],
                                                    device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # same seed as the checkpoint's run: no warning
        jt.setup()
        pt.setup()
    assert pt.current_epoch == jt.current_epoch == int(state["epoch"]) + 1 == 1
    assert pt.best_val_loss == jt.best_val_loss == float(state["best_val_loss"])
    want = flax_to_torch_state(jax.device_get(jt.params), pt.model)
    for name, p in pt.model.state_dict().items():
        assert torch.equal(p, want[name]), name  # restored bit for bit
    assert not pt.optimizer.state  # the optimizer restarts
    _three_steps(jt, pt)


def test_resume_warnings_and_shape_error_match_jax(tmp_path):
    jdir = _train_dir(tmp_path, package="jax")
    pdir = _train_dir(tmp_path, package="port")
    msgs = {}
    for pkg, run, cls, cfg in (("jax", jdir, JTrainer, JConfig), ("port", pdir, None, PConfig)):
        d = _d(seed=11)
        d["trainer_config"]["resume_ckpt_path"] = str(run / "best.ckpt")
        c = cfg.from_dict(d)
        with pytest.warns(UserWarning) as rec:
            (cls or ModelTrainer)._warn_on_resume_seed_mismatch(c)
        msgs[pkg] = [str(w.message).replace(str(run), "RUN") for w in rec]
        lone = tmp_path / f"{pkg}_lone"
        lone.mkdir()
        shutil.copytree(run / "best.ckpt", lone / "best.ckpt") if pkg == "jax" else \
            shutil.copy(run / "best.ckpt", lone / "best.ckpt")
        d["trainer_config"]["resume_ckpt_path"] = str(lone / "best.ckpt")
        with pytest.warns(UserWarning) as rec:
            (cls or ModelTrainer)._warn_on_resume_seed_mismatch(cfg.from_dict(d))
        msgs[pkg] += [str(w.message).replace(str(lone), "LONE") for w in rec]
    assert msgs["port"] == msgs["jax"]
    assert "differs from the original training seed (7)" in msgs["port"][0]
    assert "was not found" in msgs["port"][1]
    # A checkpoint of another width.
    errs = {}
    for pkg, run in (("jax", _train_dir(tmp_path, filters=4, package="jax")),
                     ("port", _train_dir(tmp_path, filters=4, package="port"))):
        d = _d()
        d["trainer_config"]["resume_ckpt_path"] = str(run / "best.ckpt")
        (jc, jl), (pc, pl) = _cfgs(d)
        t = (JTrainer.get_model_trainer_from_config(jc, [jl]) if pkg == "jax" else
             ModelTrainer.get_model_trainer_from_config(pc, [pl], device="cpu"))
        with pytest.raises(ValueError) as e:
            t.setup()
        errs[pkg] = str(e.value).replace(str(run), "RUN")
    assert errs["port"] == errs["jax"]
    assert "do not match the configured model architecture" in errs["port"]


def test_resume_refuses_a_jax_orbax_checkpoint(tmp_path):
    jdir = _train_dir(tmp_path, package="jax")
    d = _d()
    d["trainer_config"]["resume_ckpt_path"] = str(jdir / "best.ckpt")
    t = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [_labels(pio)],
                                                   device="cpu")
    with pytest.raises(ValueError, match="tools/orbax_to_torch.py"):
        t.setup()


# --- transfer init -----------------------------------------------------------


@pytest.mark.parametrize("which", ["backbone", "head"])
def test_transfer_init_matches_jax(tmp_path, which):
    src = {"port": _train_dir(tmp_path, package="port"),
           "jax": _train_dir(tmp_path, package="jax")}
    key = f"pretrained_{which}_weights"
    trainers = {}
    for pkg in ("jax", "port"):
        d = _d(seed=9)
        d["model_config"][key] = str(src[pkg])
        (jc, jl), (pc, pl) = _cfgs(d)
        t = (JTrainer.get_model_trainer_from_config(jc, [jl]) if pkg == "jax" else
             ModelTrainer.get_model_trainer_from_config(pc, [pl], device="cpu"))
        t.setup()
        trainers[pkg] = t
    pt, jt = trainers["port"], trainers["jax"]
    fresh = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(_d(seed=9)),
                                                       [_labels(pio)], device="cpu")
    fresh.setup()
    src_sd = ModelTrainer.load_checkpoint_params(src["port"] / "best.ckpt")
    jsrc = flax_to_torch_state(jax.device_get(
        JTrainer.load_checkpoint_params(src["jax"] / "best.ckpt")["params"]), pt.model)
    jgot = flax_to_torch_state(jax.device_get(jt.params), pt.model)
    moved = kept_apart = 0
    for name, p in pt.model.state_dict().items():
        taken = (param_subtree(name) == "backbone") == (which == "backbone")
        if taken:  # from the source, in both packages
            assert torch.equal(p, src_sd[name]), name
            assert torch.equal(jgot[name], jsrc[name]), name
        else:  # the trainer's own init, not the source's
            assert torch.equal(p, fresh.model.state_dict()[name]), name
            kept_apart += not torch.equal(p, src_sd[name])
        moved += taken
    assert moved > 0 and kept_apart > 0


def test_transfer_init_errors_match_jax(tmp_path):
    for what, kw in (("shapes", dict(filters=4)), ("subtree", dict(model_type="bottomup"))):
        errs = {}
        for pkg in ("jax", "port"):
            run = _train_dir(tmp_path, package=pkg, **kw)
            d = _d()
            d["model_config"]["pretrained_head_weights"] = str(run / "best.ckpt")
            if what == "shapes":
                d["model_config"]["pretrained_head_weights"] = None
                d["model_config"]["pretrained_backbone_weights"] = str(run)
            (jc, jl), (pc, pl) = _cfgs(d)
            t = (JTrainer.get_model_trainer_from_config(jc, [jl]) if pkg == "jax" else
                 ModelTrainer.get_model_trainer_from_config(pc, [pl], device="cpu"))
            with pytest.raises(ValueError) as e:
                t.setup()
            errs[pkg] = str(e.value)
        assert errs["port"] == errs["jax"], what
    assert "checkpoint has no 'CentroidConfmapsHead' subtree" in errs["port"]


def test_transfer_init_refuses_a_jax_orbax_dir(tmp_path):
    jdir = _train_dir(tmp_path, package="jax")
    d = _d()
    d["model_config"]["pretrained_backbone_weights"] = str(jdir)
    t = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [_labels(pio)],
                                                   device="cpu")
    with pytest.raises(ValueError, match="orbax checkpoint.*tools/orbax_to_torch.py"):
        t.setup()


# --- init_weights ------------------------------------------------------------


def test_init_weights_other_than_default_keep_flax_initialisers():
    d = _d()
    d["model_config"]["init_weights"] = "lecun_normal"
    d["model_config"]["backbone_config"]["unet"]["filters"] = 16
    jt, pt = _trainers(d)
    jt.setup()
    pt.setup()
    want = flax_to_torch_state(jax.device_get(jt.params), pt.model)
    xavier = ModelTrainer.get_model_trainer_from_config(
        PConfig.from_dict(_d()), [_labels(pio)], device="cpu")
    xavier.setup()
    n_checked = 0
    for name, p in pt.model.state_dict().items():
        w = want[name]
        if name.endswith("bias"):
            assert not p.any() and not w.any(), name
            continue
        fan_in = p[0].numel() if p.ndim != 4 or "trans" not in name else p.shape[0] * 9
        limit = 2 * np.sqrt(1.0 / fan_in) / 0.87962566103423978
        assert p.abs().max() <= limit * (1 + 1e-6) and w.abs().max() <= limit * (1 + 1e-6)
        if p.numel() >= 1000:
            ratio = (p.std() / w.std()).item()
            assert 0.9 < ratio < 1.1, (name, ratio)
            assert abs(p.mean().item()) < 0.1 * p.std().item(), name
            n_checked += 1
        assert not torch.equal(p, xavier.model.state_dict()[name]), name
    assert n_checked >= 5


# --- save_top_k --------------------------------------------------------------


def test_save_top_k_names_and_pruning_match_jax(tmp_path):
    runs = {}
    for pkg in ("jax", "port"):
        d = _d(max_epochs=5, train_steps_per_epoch=2, save_ckpt=True, ckpt_dir=str(tmp_path),
               run_name=pkg, model_ckpt={"save_top_k": 2},
               optimizer={"lr": 3e-3})
        (jc, jl), (pc, pl) = _cfgs(d)
        t = (JTrainer.get_model_trainer_from_config(jc, [jl]) if pkg == "jax" else
             ModelTrainer.get_model_trainer_from_config(pc, [pl], device="cpu"))
        t.setup()
        runs[pkg] = t
    pt, jt = runs["port"], runs["jax"]
    pt.model.load_state_dict(flax_to_torch_state(jax.device_get(jt.params), pt.model),
                             strict=True)
    jt.train()
    pt.train()
    names = {}
    for pkg, t in runs.items():
        kept = sorted(p.name for p in t.ckpt_dir.glob("epoch=*.ckpt"))
        assert len(kept) == 2, kept
        losses = [h["val/loss"] for h in t.history]
        best2 = sorted(range(len(losses)), key=lambda e: losses[e])[:2]
        assert kept == sorted(f"epoch={e:03d}-val_loss={losses[e]:.5f}.ckpt" for e in best2)
        names[pkg] = kept
        assert (t.ckpt_dir / "best.ckpt").exists()
    parse = [[(int(m[1]), float(m[2])) for m in
              (re.fullmatch(r"epoch=(\d{3})-val_loss=([0-9.]+)\.ckpt", n) for n in names[pkg])]
             for pkg in ("jax", "port")]
    assert [e for e, _ in parse[0]] == [e for e, _ in parse[1]]
    np.testing.assert_allclose([v for _, v in parse[1]], [v for _, v in parse[0]],
                               rtol=1e-4, atol=2e-5)
    # An epoch-stamped checkpoint loads as any other.
    ModelTrainer.load_checkpoint_params(pt.ckpt_dir / names["port"][0])


# --- negative frames -----------------------------------------------------------


def _assert_same_samples(jds, pds):
    assert len(pds) == len(jds)
    for a, b in zip(jds.samples, pds.samples):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("model_type", ["centroid", "bottomup", "single_instance"])
def test_negative_frames_match_jax(model_type):
    d = _d(model_type, train_steps_per_epoch=3)
    d["data_config"].update(use_negative_frames=True, negative_loss_weight=0.3,
                            use_same_data_for_val=True)
    negs = (1, 2, 4, 6, 9, 11)
    kw = dict(negatives=negs, seed=3 if model_type != "single_instance" else 5)
    if model_type == "single_instance":
        # One instance a frame: the single-instance trainer refuses more.
        (jc, jl), (pc, pl) = _cfgs(d, **kw)
        for L in (jl, pl):
            for lf in L.labeled_frames:
                lf.instances = lf.instances[:1]
        jt = JTrainer.get_model_trainer_from_config(jc, [jl])
        pt = ModelTrainer.get_model_trainer_from_config(pc, [pl], device="cpu")
    else:
        jt, pt = _trainers(d, **kw)
    jt.setup()
    pt.setup()
    _assert_same_samples(jt.train_ds, pt.train_ds)
    weights = [s["sample_weight"] for s in pt.train_ds.samples]
    assert weights.count(0.3) == len(negs) and set(weights) == {0.3, 1.0}
    for s in pt.train_ds.samples:
        if s["sample_weight"] == 0.3:
            assert s["num_instances"] == 0 and np.isnan(s["instances"]).all()
    assert all(s["sample_weight"] == 1.0 for s in pt.val_ds.samples)  # val: no negatives
    batches = list(pt.train_loader._gen())[:3]
    assert any((b["sample_weight"] == np.float32(0.3)).any() for b in batches)
    # The render of a negative is an empty target, as in JAX.
    neg = [i for i, s in enumerate(pt.train_ds.samples) if s["sample_weight"] == 0.3][:2]
    got = pt.render(pt.train_ds.make_batch(neg), train=False)
    assert not got["confmaps"].any()
    _three_steps(jt, pt)


def test_negative_frames_skip_crop_models_with_the_jax_warning():
    d = _d("centered_instance")
    d["data_config"].update(use_negative_frames=True)
    d["data_config"]["preprocessing"] = {"crop_size": 32}
    jt, pt = _trainers(d, negatives=(1, 2))
    with pytest.warns(UserWarning, match="Negative frames will be disabled") as want:
        jt.setup()
    with pytest.warns(UserWarning, match="Negative frames will be disabled") as got:
        pt.setup()
    assert str(got[0].message) == str(want[0].message)
    _assert_same_samples(jt.train_ds, pt.train_ds)


# --- user centroids ----------------------------------------------------------


def test_user_centroids_match_jax():
    d = _d("centroid", train_steps_per_epoch=3)
    d["model_config"]["head_configs"]["centroid"]["confmaps"]["centroid_source"] = "user"
    d["data_config"]["use_same_data_for_val"] = True
    jt, pt = _trainers(d, user_centroids=(0, 3, 4, 7, 10))
    jt.setup()
    pt.setup()
    assert pt.ctx.max_instances == jt.ctx.max_instances
    _assert_same_samples(jt.train_ds, pt.train_ds)
    user = [i for i, s in enumerate(pt.train_ds.samples)
            if s["frame_idx"] in (0, 3, 4, 7, 10)]
    assert len(user) == 5
    for i in user:  # every node at the annotated centroid
        s = pt.train_ds.samples[i]
        pts = s["instances"][: s["num_instances"]]
        assert (pts == pts[:, :1]).all() and not np.isnan(pts).any()
    batch = pt.train_ds.make_batch(user[:4])
    want = jpipe.make_render_fn(jt.ctx, train=False)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = ppipe.make_render_fn(pt.ctx, train=False)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_array_equal(got["centroids"].numpy(), np.asarray(want["centroids"]))
    np.testing.assert_allclose(got["confmaps"].numpy(), np.asarray(want["confmaps"]),
                               rtol=0, atol=1e-6)
    assert got["confmaps"].max() > 0.9
    _three_steps(jt, pt)


def test_user_centroid_errors_match_jax():
    # No user-annotated centroid in the labels.
    d = _d("centroid")
    d["model_config"]["head_configs"]["centroid"]["confmaps"]["centroid_source"] = "user"
    (jc, jl), (pc, pl) = _cfgs(d)
    with pytest.raises(ValueError) as want:
        JTrainer.get_model_trainer_from_config(jc, [jl])
    with pytest.raises(ValueError) as got:
        ModelTrainer.get_model_trainer_from_config(pc, [pl], device="cpu")
    assert str(got.value) == str(want.value)
    assert "no user-annotated centroid records" in str(got.value)
    # A model type other than centroid.
    (jc, jl), (pc, pl) = _cfgs(_d("bottomup"), user_centroids=(0,))
    jhead_config(jc).confmaps.centroid_source = "user"
    phead_config(pc).confmaps.centroid_source = "user"
    with pytest.raises(ValueError) as want:
        JTrainer.get_model_trainer_from_config(jc, [jl])
    with pytest.raises(ValueError) as got:
        ModelTrainer.get_model_trainer_from_config(pc, [pl], device="cpu")
    assert str(got.value) == str(want.value)
    assert "only applies to centroid models" in str(got.value)


# --- AMSGrad ---------------------------------------------------------------------


def test_amsgrad_matches_optax():
    d = _d("centroid", train_steps_per_epoch=3, optimizer={"amsgrad": True})
    jt, pt = _trainers(d)
    jt.setup()
    pt.setup()
    assert isinstance(pt.optimizer, AMSGrad)
    _three_steps(jt, pt)


def test_amsgrad_update_rule_is_optax_not_torch():
    """On one tensor over 5 steps of shrinking gradients (where the two
    rules part): optax's rule to 1e-6, and not torch's ``amsgrad``."""
    import optax

    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(64,)).astype(np.float32)
    grads = [rng.normal(size=(64,)).astype(np.float32) * 0.5 ** i for i in range(5)]
    tx = optax.amsgrad(1e-2)
    p, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_optimizer([tp], "adam", 1e-2, amsgrad=True)
    tref = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    ref = torch.optim.Adam([tref], lr=1e-2, amsgrad=True)
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
        for param, o in ((tp, opt), (tref, ref)):
            param.grad = torch.from_numpy(g.copy())
            o.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(p), rtol=0, atol=1e-6)
    assert np.abs(tref.detach().numpy() - np.asarray(p)).max() > 1e-4


def test_adamw_with_amsgrad_raises_like_jax():
    d = _d("centroid", optimizer_name="AdamW", optimizer={"amsgrad": True})
    jt, pt = _trainers(d)
    with pytest.raises(ValueError) as want:
        jt.setup()
    with pytest.raises(ValueError) as got:
        pt.setup()
    assert str(got.value) == str(want.value)
