"""Port parity: training the three segmentation model types (the render,
datasets, heads and losses, ``ModelTrainer`` and the epoch-end
``val/fg_iou``) against the JAX package.

Each type runs in both packages on the same in-memory labels (64x64
numpy-made frames, a 3-node chain skeleton, UNet filters 8, max_stride 8)
on the CPU, with the tolerances of ``tests/test_torch_training.py``:
host values identical; the render's ``image`` exactly and its
segmentation targets to 1e-6; 3 train steps from the same initial
parameters with losses to 1e-5 relative, step-0 gradients to 1e-4 of each
tensor's largest magnitude, parameters after 3 Adam steps to 1e-5
absolute and the val loss to 1e-5 relative.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.data import pipeline as jpipe
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.training import ModelTrainer as JTrainer
from sleap_nn_tpu.training import losses as jlosses
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.data import pipeline as ppipe
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.train import run_training
from sleap_nn_tpu_torch.training import ModelTrainer
from sleap_nn_tpu_torch.training import losses as plosses
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_pipeline import cfg_dict, make_labels
from tests.test_torch_training import _jax_grads
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

TYPES = ("bottomup_segmentation", "semantic_segmentation", "centered_instance_segmentation")
SEG_HEADS = {
    "bottomup_segmentation": {"segmentation": {"output_stride": 2},
                              "center": {"sigma": 3.0, "output_stride": 2},
                              "offsets": {"output_stride": 2}},
    "semantic_segmentation": {"segmentation": {"output_stride": 2, "bce_pos_weight": 2.0}},
    "centered_instance_segmentation": {"segmentation": {"output_stride": 2}},
}
TARGETS = {"bottomup_segmentation": ("segmentation", "center_heatmap", "center_offsets",
                                     "offsets_mask"),
           "semantic_segmentation": ("segmentation",),
           "centered_instance_segmentation": ("segmentation",)}


def seg_cfg(model_type, augment=False, **trainer):
    d = cfg_dict(augment=augment, **trainer)
    d["model_config"]["head_configs"] = {model_type: copy.deepcopy(SEG_HEADS[model_type])}
    return d


def _labels(io, seed=0):
    return make_labels(io, n_frames=12, seed=seed)


@pytest.mark.parametrize("model_type", TYPES)
@pytest.mark.parametrize("augment", [False, True])
def test_contexts_datasets_and_render_match(model_type, augment):
    d = seg_cfg(model_type, augment=augment)
    jl, pl = _labels(jio), _labels(pio)
    jctx = jpipe.build_pipeline_context(JConfig.from_dict(d), jl, model_type)
    pctx = ppipe.build_pipeline_context(PConfig.from_dict(d), pl, model_type)
    jd, pd = jctx.__dict__, pctx.__dict__
    assert {k: jd[k] for k in pd} == pd  # every field the port has, as JAX sets it
    assert pctx.edge_inds == ((0, 1), (1, 2))
    jds = jpipe.make_dataset(model_type, [jl], jctx)
    pds = ppipe.make_dataset(model_type, [pl], pctx)
    assert len(jds) == len(pds) and type(pds).__name__ == type(jds).__name__
    batch = jds.make_batch([0, 3, 5, 7])
    pbatch = pds.make_batch([0, 3, 5, 7])
    for k in batch:
        np.testing.assert_array_equal(batch[k], pbatch[k], err_msg=k)
    # Without augmentation (the two packages draw it differently).
    want = jpipe.make_render_fn(jctx, train=False)({k: jnp.asarray(v) for k, v in batch.items()})
    got = ppipe.make_render_fn(pctx, train=False)({k: torch.from_numpy(v)
                                                    for k, v in batch.items()})
    np.testing.assert_array_equal(got["image"].numpy(), np.asarray(want["image"]))
    np.testing.assert_array_equal(np.isnan(got["instances"].numpy()),
                                  np.isnan(np.asarray(want["instances"])))
    for k in TARGETS[model_type]:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
    assert got["segmentation"].sum() > 0


@pytest.mark.parametrize("model_type", TYPES)
def test_tiled_segmentation_datasets_match(model_type):
    if model_type == "centered_instance_segmentation":
        return  # crop models do not tile, in either package
    d = seg_cfg(model_type, max_epochs=1, train_steps_per_epoch=1)
    d["data_config"]["preprocessing"] = {"tiling": {"enabled": True, "tile_size": 32,
                                                    "overlap": 8}}
    jt = JTrainer.get_model_trainer_from_config(JConfig.from_dict(d), [_labels(jio)])
    jt.setup()
    pt = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [_labels(pio)],
                                                    device="cpu")
    pt.setup()
    assert type(pt.train_ds).__name__ == type(jt.train_ds).__name__ == "TiledDataset"
    assert type(pt.train_ds.inner).__name__ == type(jt.train_ds.inner).__name__
    assert len(pt.train_ds) == len(jt.train_ds)
    for i in (0, 5):
        a, b = jt.train_ds.get_sample(i), pt.train_ds.get_sample(i)
        np.testing.assert_array_equal(a["image"], b["image"])
        np.testing.assert_array_equal(a["instances"], b["instances"])


def test_segmentation_losses_match_jax():
    rng = np.random.default_rng(0)
    y = (rng.random((3, 8, 10, 1)) < 0.4).astype(np.float32)
    p = np.clip(y * 0.7 + rng.random(y.shape) * 0.3, 1e-4, 1 - 1e-4).astype(np.float32)
    for kw in ({}, {"bce_weight": 0.2, "dice_weight": 0.8}, {"pos_weight": 3.0}):
        np.testing.assert_allclose(
            plosses.bce_dice_on_probs(torch.from_numpy(p), torch.from_numpy(y), **kw).item(),
            float(jlosses.bce_dice_on_probs(jnp.asarray(p), jnp.asarray(y), **kw)), rtol=1e-5)
    off = rng.normal(0, 3, (3, 8, 10, 2)).astype(np.float32)
    tgt = rng.normal(0, 3, (3, 8, 10, 2)).astype(np.float32)
    m = (rng.random((3, 8, 10, 1)) < 0.5).astype(np.float32)
    for mask in (m, np.zeros_like(m)):
        np.testing.assert_allclose(
            plosses.compute_masked_smooth_l1(*map(torch.from_numpy, (off, tgt, mask))).item(),
            float(jlosses.compute_masked_smooth_l1(*map(jnp.asarray, (off, tgt, mask)))),
            rtol=1e-5, atol=1e-12)


def _trainers(model_type, **trainer_kw):
    jt = JTrainer.get_model_trainer_from_config(
        JConfig.from_dict(seg_cfg(model_type, **trainer_kw)), [_labels(jio)])
    jt.setup()
    pt = ModelTrainer.get_model_trainer_from_config(
        PConfig.from_dict(seg_cfg(model_type, **trainer_kw)), [_labels(pio)], device="cpu")
    pt.setup()
    pt.model.load_state_dict(flax_to_torch_state(jax.device_get(jt.params), pt.model),
                             strict=True)
    return jt, pt


@pytest.mark.parametrize("model_type", TYPES)
def test_trainer_steps_match_jax(model_type):
    jt, pt = _trainers(model_type)
    assert [h.name for h in pt.model.heads] == [h.name for h in jt.model.heads]
    assert pt.config.data_config.preprocessing.crop_size == \
        jt.config.data_config.preprocessing.crop_size
    assert pt._input_shape == tuple(jt._input_shape)
    jbatches, pbatches = list(jt.train_loader._gen()), list(pt.train_loader._gen())
    assert len(jbatches) == len(pbatches) >= 3
    for a, b in zip(jbatches, pbatches):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    batches = jbatches[-3:]
    params, opt_state = jt.params, jt.tx.init(jt.params)
    cp = lambda t: jax.tree_util.tree_map(lambda x: x.copy(), t)  # noqa: E731 (donated)
    for step, batch in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if step == 0:
            want_grads = flax_to_torch_state(jax.device_get(_jax_grads(jt, jbatch)), pt.model)
        params, opt_state, want_loss, want_parts = jt._train_step(
            cp(params), cp(opt_state), jbatch, jax.random.PRNGKey(step))
        got_loss, got_parts = pt.train_step(batch)
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
        assert set(got_parts) == set(want_parts)
        for k in want_parts:
            np.testing.assert_allclose(float(got_parts[k]), float(want_parts[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
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


@pytest.mark.parametrize("model_type", TYPES)
def test_epoch_end_fg_iou_matches_jax(model_type):
    """One epoch of 3 steps with ``eval.enabled``: ``val/fg_iou`` equals the
    JAX trainer's. Both apply a second sigmoid to the head's probabilities,
    so every pixel counts as foreground: the IoU is the target's
    foreground share of the val frames."""
    jt, pt = _trainers(model_type, eval={"enabled": True}, max_epochs=1,
                       train_steps_per_epoch=3)
    jt.train()
    pt.train()
    want, got = jt.history[-1]["val/fg_iou"], pt.history[-1]["val/fg_iou"]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    gt = fg = 0.0
    for batch in pt.eval_loader:
        seg = pt.render(batch, train=False)["segmentation"][..., 0].numpy() > 0.5
        seg = seg[np.asarray(batch["batch_mask"], bool)]
        gt, fg = gt + seg.sum(), fg + seg.size
    np.testing.assert_allclose(got, gt / fg, rtol=1e-12)


@pytest.mark.parametrize("model_type", TYPES)
def test_train_on_cpu_writes_a_loadable_checkpoint(model_type, tmp_path):
    d = seg_cfg(model_type, augment=True, max_epochs=1, train_steps_per_epoch=2, save_ckpt=True,
                ckpt_dir=str(tmp_path), run_name="run")
    trainer = run_training(PConfig.from_dict(d), [_labels(pio)], device="cpu")
    assert len(trainer.history) == 1 and np.isfinite(trainer.history[0]["train/loss"])
    head_cfg = getattr(trainer.config.model_config.head_configs, model_type)
    fresh = Model.from_config("unet", trainer.config.model_config.backbone_config.unet, head_cfg,
                              model_type)
    fresh.load_state_dict(ModelTrainer.load_checkpoint_params(tmp_path / "run" / "best.ckpt"),
                          strict=True)
    assert [h.name for h in fresh.heads] == [h.name for h in trainer.model.heads]


def test_negative_frames_and_tiling_refused_for_the_crop_type_like_jax():
    d = seg_cfg("centered_instance_segmentation")
    d["data_config"]["preprocessing"] = {"tiling": {"enabled": True, "tile_size": 32}}
    with pytest.raises(ValueError, match="Tiled training is not supported") as jerr:
        JTrainer.get_model_trainer_from_config(JConfig.from_dict(d), [_labels(jio)]).setup()
    with pytest.raises(ValueError, match="Tiled training is not supported") as perr:
        ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [_labels(pio)],
                                                   device="cpu").setup()
    assert str(perr.value) == str(jerr.value)
