"""Port parity: training the single-instance, centered-instance and bottom-up
models (``data/pipeline.py``, ``training/model_trainer.py``) against the JAX
package.

Each model type runs in both packages on the same in-memory labels
(64x64 numpy-made frames, a 3-node chain skeleton, UNet filters 8,
max_stride 8, augmentation off), on the CPU. Host values (contexts,
samples with their ``center_idx``, loader batches, crop sizes) must be
identical. The render: ``image``, ``instances`` and ``centroids`` exactly,
``confmaps`` and ``pafs`` to 1e-6 absolute (``exp`` of the same f32
arguments). The trainers, from the same initial parameters over the same
3 batches (the last one padded): losses to 1e-5 relative, step-0
gradients to 1e-4 of each tensor's largest magnitude, parameters after 3
Adam steps to 1e-5 absolute, the val loss to 1e-5 relative with the same
part names (the tolerances of ``tests/test_torch_training.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.data import pipeline as jpipe
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.training import ModelTrainer as JTrainer
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.data import pipeline as ppipe
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.train import run_training
from sleap_nn_tpu_torch.training import ModelTrainer
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_pipeline import cfg_dict, make_labels
from tests.test_torch_training import _jax_grads
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

TYPES = ("single_instance", "centered_instance", "bottomup")
TARGETS = {"single_instance": ("confmaps",), "centered_instance": ("confmaps",),
           "bottomup": ("confmaps", "pafs")}
EXACT = ("image", "instances", "centroids")


def _labels(io, model_type, n_frames=12, seed=0):
    """One instance per frame for single-instance models, 1-3 otherwise."""
    return make_labels(io, n_frames=n_frames, seed=seed,
                       max_inst=1 if model_type == "single_instance" else 3)


def _cfg(model_type, augment=False, crop_size=None, min_crop_size=None, **trainer):
    d = cfg_dict(augment=augment, model_type=model_type, **trainer)
    pre = {k: v for k, v in (("crop_size", crop_size), ("min_crop_size", min_crop_size))
           if v is not None}
    if pre:
        d["data_config"]["preprocessing"] = pre
    return d


def _contexts(model_type, **cfg_kw):
    d = _cfg(model_type, **cfg_kw)
    jl, pl = _labels(jio, model_type), _labels(pio, model_type)
    return (jpipe.build_pipeline_context(JConfig.from_dict(d), jl, model_type), jl,
            ppipe.build_pipeline_context(PConfig.from_dict(d), pl, model_type), pl)


@pytest.mark.parametrize("model_type,cfg_kw", [
    ("single_instance", {}), ("bottomup", {}), ("bottomup", {"augment": True}),
    ("centered_instance", {}), ("centered_instance", {"augment": True}),
    ("centered_instance", {"augment": True, "min_crop_size": 20}),
    ("centered_instance", {"crop_size": 40}),
])
def test_build_pipeline_context_matches(model_type, cfg_kw):
    jctx, _, pctx, _ = _contexts(model_type, **cfg_kw)
    for f in dataclasses.fields(pctx):
        assert getattr(pctx, f.name) == getattr(jctx, f.name), f.name
    if model_type == "centered_instance":
        assert pctx.crop_size % 8 == 0 or cfg_kw.get("crop_size")
    if model_type == "bottomup":
        assert pctx.edge_inds == ((0, 1), (1, 2)) and pctx.pafs_output_stride == 4


@pytest.mark.parametrize("model_type", TYPES)
def test_datasets_and_loader_match(model_type):
    jctx, jl, pctx, pl = _contexts(model_type)
    jds, pds = jpipe.make_dataset(model_type, [jl], jctx), ppipe.make_dataset(model_type, [pl], pctx)
    assert type(pds).__name__ == type(jds).__name__
    assert len(pds) == len(jds) > len(pl) * (model_type == "centered_instance")
    for a, b in zip(jds.samples, pds.samples):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    if model_type == "centered_instance":
        assert [s["center_idx"] for s in pds.samples] == [
            k for lf in pl for k in range(len(lf.user_instances))]
    jload = jpipe.Loader(jds, 4, shuffle=True, seed=7, prefetch=0)
    pload = ppipe.Loader(pds, 4, shuffle=True, seed=7, prefetch=2)
    for epoch in (0, 1):
        jload.set_epoch(epoch)
        pload.set_epoch(epoch)
        jb, pb = list(jload), list(pload)
        assert len(jb) == len(pb) == len(pload)
        for a, b in zip(jb, pb):
            assert set(a) == set(b) and ("center_idx" in b) == (model_type == "centered_instance")
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _compare_render(want, got, keys):
    for k in keys:
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
    assert want["eff_scale"] == got["eff_scale"]


@pytest.mark.parametrize("model_type,cfg_kw", [
    ("single_instance", {}), ("bottomup", {}), ("centered_instance", {}),
    ("centered_instance", {"crop_size": 32}),
])
def test_make_render_fn_matches(model_type, cfg_kw):
    jctx, jl, pctx, pl = _contexts(model_type, **cfg_kw)
    inds = [0, 3, 5, 8]
    batch = jpipe.make_dataset(model_type, [jl], jctx).make_batch(inds)
    pbatch = ppipe.make_dataset(model_type, [pl], pctx).make_batch(inds)
    want = jpipe.make_render_fn(jctx, train=False)({k: jnp.asarray(v) for k, v in batch.items()})
    got = ppipe.make_render_fn(pctx, train=False)(
        {k: torch.from_numpy(v) for k, v in pbatch.items()})
    keys = [k for k in EXACT if k in want] + list(TARGETS[model_type])
    assert set(got) == set(want)
    _compare_render(want, got, keys)
    for k in TARGETS[model_type]:
        assert np.abs(np.asarray(want[k])).max() > 0.5, k  # the targets are not empty
    if model_type == "centered_instance":
        side = cfg_kw.get("crop_size", pctx.crop_size)
        assert got["image"].shape == (4, side, side, 1)


# --- the trainers ------------------------------------------------------------


def _trainers(model_type, **trainer_kw):
    jt = JTrainer.get_model_trainer_from_config(
        JConfig.from_dict(_cfg(model_type, **trainer_kw)), [_labels(jio, model_type)])
    jt.setup()
    pt = ModelTrainer.get_model_trainer_from_config(
        PConfig.from_dict(_cfg(model_type, **trainer_kw)), [_labels(pio, model_type)],
        device="cpu")
    pt.setup()
    pt.model.load_state_dict(flax_to_torch_state(jax.device_get(jt.params), pt.model),
                             strict=True)
    return jt, pt


@pytest.mark.parametrize("model_type", TYPES)
def test_trainer_steps_match_jax(model_type):
    jt, pt = _trainers(model_type)
    jpre, ppre = jt.config.data_config.preprocessing, pt.config.data_config.preprocessing
    assert ppre.crop_size == jpre.crop_size
    assert (ppre.crop_size is not None) == (model_type == "centered_instance")
    jhead = getattr(jt.config.model_config.head_configs, model_type)
    phead = getattr(pt.config.model_config.head_configs, model_type)
    assert phead.confmaps.part_names == jhead.confmaps.part_names == ["n0", "n1", "n2"]
    if model_type == "bottomup":  # the edges filled from the skeleton
        assert phead.pafs.edges == jhead.pafs.edges == [["n0", "n1"], ["n1", "n2"]]
    assert pt._input_shape == tuple(jt._input_shape)
    jbatches, pbatches = list(jt.train_loader._gen()), list(pt.train_loader._gen())
    assert len(jbatches) == len(pbatches) >= 3
    for a, b in zip(jbatches, pbatches):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    batches = jbatches[-3:]
    assert not batches[-1]["batch_mask"].all()  # a padded batch
    params, opt_state = jt.params, jt.tx.init(jt.params)
    copy = lambda t: jax.tree_util.tree_map(lambda x: x.copy(), t)  # noqa: E731 (donated)
    for step, batch in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if step == 0:
            want_grads = flax_to_torch_state(jax.device_get(_jax_grads(jt, jbatch)), pt.model)
        params, opt_state, want_loss, want_parts = jt._train_step(
            copy(params), copy(opt_state), jbatch, jax.random.PRNGKey(step))
        got_loss, got_parts = pt.train_step(batch)
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
        assert set(got_parts) == set(want_parts)
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


def test_single_instance_label_check_raises_like_jax():
    d = _cfg("single_instance")
    with pytest.raises(ValueError, match="at most one instance") as jerr:
        JTrainer.get_model_trainer_from_config(JConfig.from_dict(d), [make_labels(jio)])
    with pytest.raises(ValueError, match="at most one instance") as perr:
        ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [make_labels(pio)],
                                                   device="cpu")
    assert str(perr.value) == str(jerr.value)


@pytest.mark.parametrize("model_type", TYPES)
def test_train_on_cpu_writes_a_loadable_checkpoint(model_type, tmp_path):
    d = _cfg(model_type, augment=True, max_epochs=1, train_steps_per_epoch=2, save_ckpt=True,
             ckpt_dir=str(tmp_path), run_name="run")
    trainer = run_training(PConfig.from_dict(d), [_labels(pio, model_type)], device="cpu")
    assert len(trainer.history) == 1 and np.isfinite(trainer.history[0]["train/loss"])
    head_cfg = getattr(trainer.config.model_config.head_configs, model_type)
    fresh = Model.from_config("unet", trainer.config.model_config.backbone_config.unet, head_cfg,
                              model_type)
    fresh.load_state_dict(ModelTrainer.load_checkpoint_params(tmp_path / "run" / "best.ckpt"),
                          strict=True)
    assert [h.name for h in fresh.heads] == [h.name for h in trainer.model.heads]


# --- epoch-end evaluation ----------------------------------------------------


def _eval_callback(trainer):
    return next(cb for cb in trainer.callbacks if type(cb).__name__ == "EpochEndEvaluationCallback")


def _assert_logs_close(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("model_type", ("single_instance", "centered_instance", "centroid",
                                        "bottomup"))
def test_epoch_end_eval_matches_jax(model_type):
    """3 steps with ``eval.enabled``: the epoch's ``val/*`` logs match the
    JAX trainer's. Then, with 1 added to the confmap head's bias in both
    (maps near 1, so every node has a well-conditioned peak), the callback
    of each package gives the same metrics on the same weights."""
    jt, pt = _trainers(model_type, eval={"enabled": True}, max_epochs=1,
                       train_steps_per_epoch=3)
    jt.train()
    pt.train()
    keys = lambda h: {k: v for k, v in h.items()  # noqa: E731
                      if k.startswith("val/") and k != "val/loss" and "confmap" not in k}
    want, got = keys(jt.history[-1]), keys(pt.history[-1])
    expected = {"single_instance": {"val/mOKS", "val/dist.avg"},
                "centered_instance": {"val/mOKS", "val/dist.avg"},
                "centroid": {"val/dist.avg", "val/detection.f1"}, "bottomup": set()}[model_type]
    # After 3 steps no centroid peak clears 0.2, so there is no distance yet.
    assert expected - ({"val/dist.avg"} if model_type == "centroid" else set()) <= set(want)
    _assert_logs_close(got, want)
    pt.model.train()
    _eval_callback(pt)._evaluate(pt)
    assert pt.model.training and torch.is_grad_enabled()  # the mode is restored

    head = next(h.name for h in pt.model.heads if "Confmaps" in h.name)
    with torch.no_grad():
        next(layer[head][0] for layer in pt.model.head_layers if head in layer).bias.add_(1.0)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params))
    params["params"][head]["head_conv"]["bias"] = params["params"][head]["head_conv"]["bias"] + 1
    jt.params = params
    want, got = _eval_callback(jt)._evaluate(jt), _eval_callback(pt)._evaluate(pt)
    assert set(want) == expected
    _assert_logs_close(got, want)
    if model_type != "bottomup":
        assert np.isfinite(want["val/dist.avg"])
