"""Port parity for the slice as a whole: identity (multi-class) models,
``multi_class_bottomup`` and ``multi_class_topdown``, trained and predicted
against the JAX package on the CPU.

Labels carry tracks: each instance one of 3 ``Track``s, distinct within
its frame, some instances untracked (class index -1).

- Training (as ``tests/test_torch_model_types.py``; 64x64 numpy-made
  frames, a 3-node chain, UNet filters 8, max_stride 8): contexts,
  samples and loader batches identical; the render's ``image``,
  ``instances`` and ``centroids`` exactly, ``confmaps``, ``class_maps``
  and ``class_vectors`` to 1e-6 absolute; 3 trainer steps from the same
  parameters: losses to 1e-5 relative, ``class_accuracy`` exactly, the
  step-0 loss parts to 1e-5 relative (later steps' parts to 1e-4: Adam's
  updates carry the f32 differences of the gradients, and a small part
  shows them), step-0 gradients to 1e-4 of each tensor's largest
  magnitude, parameters after the first Adam step to 1e-5 absolute and
  after 3 steps to 1e-5 (bottom-up) or 1e-4 (top-down; see
  ``test_trainer_steps_match_jax``); the epoch
  logs' losses, ``class_accuracy`` and the epoch-end evaluation's
  ``val/*`` to 1e-5 (the other parts' logs to 1e-4).
- The layers (as ``tests/test_torch_topdown.py`` and
  ``test_torch_bottomup.py``: blob frames, zero biases, confmap heads
  scaled onto [0, 1]), the same weights in both packages: validity,
  class indices and NaN placement exact, keypoints, values and class
  probabilities to 1e-4 (top-down) and 1e-5 (bottom-up). A bottom-up case
  with every class probability tied (0.5) checks the scan order.
- Model dirs trained by the port: a dir loads strictly and predicts what
  the in-memory model predicts, exactly; the JAX package's
  ``Predictor.from_model_paths`` reads the dirs and predicts the same, to
  the layers' tolerances, with the same class tracks; a ``.slp`` written
  by the port keeps every instance's track for both packages' readers.
"""

import copy
import dataclasses
import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.data import pipeline as jpipe
from sleap_nn_tpu.inference import layers as jl
from sleap_nn_tpu.inference.backends import JaxBackend
from sleap_nn_tpu.inference.predictor import Predictor as JaxPredictor
from sleap_nn_tpu.inference.providers import VideoProvider as JaxVideoProvider
from sleap_nn_tpu.inference.run import predict as jax_predict
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu.training import ModelTrainer as JTrainer
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.config.model_config import UNetConfig
from sleap_nn_tpu_torch.data import pipeline as ppipe
from sleap_nn_tpu_torch.inference import layers as tl
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.inference.backends import TorchBackend
from sleap_nn_tpu_torch.inference.loaders import load_model
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.models.model import Model
from sleap_nn_tpu_torch.training import ModelTrainer
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_model_dir import FrameVideo
from tests.test_torch_pipeline import ArrayVideo, cfg_dict
from tests.test_torch_topdown import blob_frames
from tests.test_torch_training import _jax_grads
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

ns = types.SimpleNamespace
TYPES = ("multi_class_bottomup", "multi_class_topdown")
N_CLASSES, N_NODES, HW = 3, 3, 64
TARGETS = {"multi_class_bottomup": ("confmaps", "class_maps"),
           "multi_class_topdown": ("confmaps", "class_vectors")}
EXACT = ("image", "instances", "centroids")


def id_labels(io, n_frames=12, hw=(HW, HW), max_inst=3, seed=0, frames=None, spread=None):
    """Labels in ``io``'s data model from a numpy seed: 1..max_inst 3-node
    instances a frame, each of a distinct track of 3 (about one in five
    untracked), some nodes missing. ``spread`` places instances as point
    clouds of that spread (else uniformly, some nodes out of bounds)."""
    rng = np.random.default_rng(seed)
    if frames is None:
        frames = rng.integers(0, 256, (n_frames, *hw, 1), dtype=np.uint8)
    video = ArrayVideo(frames)
    skel = io.Skeleton([f"n{i}" for i in range(N_NODES)],
                       edges=[(i, i + 1) for i in range(N_NODES - 1)])
    tracks = [io.Track(name=f"id{c}") for c in range(N_CLASSES)]
    lfs = []
    for f in range(len(frames)):
        insts = []
        for c in rng.permutation(N_CLASSES)[:int(rng.integers(1, max_inst + 1))]:
            if spread is None:
                pts = rng.uniform(-2, max(hw) + 2, (N_NODES, 2))
                pts[rng.random(N_NODES) < 0.2] = np.nan
            else:
                pts = rng.uniform(12, min(hw) - 12, 2) + rng.normal(0, spread, (N_NODES, 2))
            track = None if rng.random() < 0.2 else tracks[c]
            insts.append(io.Instance(pts, skel, track=track))
        lfs.append(io.LabeledFrame(video, f, insts))
    return io.Labels(lfs, tracks=tracks)


def head_configs(model_type, global_pool=True, fc_layers=1):
    cm = {"sigma": 2.5, "output_stride": 2}
    if model_type == "multi_class_bottomup":
        return {"confmaps": cm, "class_maps": {"sigma": 3.0, "output_stride": 4}}
    return {"confmaps": {"anchor_part": None, **cm},
            "class_vectors": {"num_fc_layers": fc_layers, "num_fc_units": 16,
                              "global_pool": global_pool}}


def _cfg(model_type, augment=False, crop_size=None, heads=None, **trainer):
    d = cfg_dict(augment=augment, **trainer)
    d["model_config"]["head_configs"] = {model_type: head_configs(model_type, **(heads or {}))}
    if crop_size is not None:
        d["data_config"]["preprocessing"] = {"crop_size": crop_size}
    return d


def _contexts(model_type, **cfg_kw):
    d = _cfg(model_type, **cfg_kw)
    jlab, plab = id_labels(jio), id_labels(pio)
    return (jpipe.build_pipeline_context(JConfig.from_dict(d), jlab, model_type), jlab,
            ppipe.build_pipeline_context(PConfig.from_dict(d), plab, model_type), plab)


# --- the training pipeline ----------------------------------------------------


@pytest.mark.parametrize("model_type,cfg_kw", [
    ("multi_class_bottomup", {}), ("multi_class_bottomup", {"augment": True}),
    ("multi_class_topdown", {}), ("multi_class_topdown", {"augment": True}),
    ("multi_class_topdown", {"crop_size": 40}),
])
def test_build_pipeline_context_matches(model_type, cfg_kw):
    jctx, _, pctx, _ = _contexts(model_type, **cfg_kw)
    for f in dataclasses.fields(pctx):
        assert getattr(pctx, f.name) == getattr(jctx, f.name), f.name
    assert pctx.n_classes == N_CLASSES
    if model_type == "multi_class_bottomup":
        assert (pctx.class_maps_sigma, pctx.class_maps_output_stride) == (3.0, 4)
    else:
        assert pctx.crop_size % 8 == 0 or cfg_kw.get("crop_size")


@pytest.mark.parametrize("model_type", TYPES)
def test_datasets_and_loader_match(model_type):
    jctx, jlab, pctx, plab = _contexts(model_type)
    jds, pds = jpipe.make_dataset(model_type, [jlab], jctx), ppipe.make_dataset(model_type, [plab],
                                                                                pctx)
    assert type(pds).__name__ == type(jds).__name__
    assert len(pds) == len(jds)
    for a, b in zip(jds.samples, pds.samples):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)
    ids = np.concatenate([s["track_ids"] for s in pds.samples])
    assert {-1, 0, 1, 2} <= set(ids.tolist())  # tracked, untracked and padding slots
    jload = jpipe.Loader(jds, 4, shuffle=True, seed=7, prefetch=0)
    pload = ppipe.Loader(pds, 4, shuffle=True, seed=7, prefetch=2)
    for epoch in (0, 1):
        jload.set_epoch(epoch)
        pload.set_epoch(epoch)
        for a, b in zip(list(jload), list(pload)):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("model_type,cfg_kw", [
    ("multi_class_bottomup", {}), ("multi_class_topdown", {}),
    ("multi_class_topdown", {"crop_size": 32}),
])
def test_make_render_fn_matches(model_type, cfg_kw):
    jctx, jlab, pctx, plab = _contexts(model_type, **cfg_kw)
    n = len(jpipe.make_dataset(model_type, [jlab], jctx))
    inds = [0, 3, 5, n - 1]
    batch = jpipe.make_dataset(model_type, [jlab], jctx).make_batch(inds)
    pbatch = ppipe.make_dataset(model_type, [plab], pctx).make_batch(inds)
    want = jpipe.make_render_fn(jctx, train=False)({k: jnp.asarray(v) for k, v in batch.items()})
    got = ppipe.make_render_fn(pctx, train=False)(
        {k: torch.from_numpy(v) for k, v in pbatch.items()})
    assert set(got) == set(want)
    for k in [k for k in EXACT if k in want] + list(TARGETS[model_type]):
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        if k in EXACT:
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
    assert want["eff_scale"] == got["eff_scale"]
    target = np.asarray(want[TARGETS[model_type][1]])
    assert target.max() > 0.5  # the class targets are not empty
    if model_type == "multi_class_bottomup":
        assert target.shape == (4, HW // 4, HW // 4, N_CLASSES)
    else:  # untracked crops give all-zero vectors
        assert set(target.sum(-1).tolist()) <= {0.0, 1.0}


# --- the trainers ---------------------------------------------------------------


def _trainers(model_type, heads=None, **trainer_kw):
    d = _cfg(model_type, heads=heads, **trainer_kw)
    jt = JTrainer.get_model_trainer_from_config(JConfig.from_dict(d), [id_labels(jio)])
    jt.setup()
    pt = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(copy.deepcopy(d)),
                                                    [id_labels(pio)], device="cpu")
    pt.setup()
    pt.model.load_state_dict(flax_to_torch_state(jax.device_get(jt.params), pt.model),
                             strict=True)
    return jt, pt


TRAIN_CASES = [("multi_class_bottomup", None), ("multi_class_topdown", None),
               ("multi_class_topdown", {"global_pool": False, "fc_layers": 2})]


def _assert_parts_close(got, want, rtol=1e-5):
    """Loss parts: ``class_accuracy`` exactly, the others to ``rtol``."""
    assert set(got) == set(want)
    for k in want:
        tol = 0 if k == "class_accuracy" else rtol
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=tol, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("model_type,heads", TRAIN_CASES)
def test_trainer_steps_match_jax(model_type, heads):
    """3 steps from the same parameters. The top-down crops hold zero
    padding beyond the frame: after the first step the biases are no
    longer 0 and such a constant region gives many pixels one shared
    pre-activation, here within float noise of the ReLU kink (249 pixels of
    one 26x26 map at 5.6e-7), so the two packages can gate the whole region
    apart and the later gradients part by up to 1% of a tensor's largest.
    The losses still agree to 1e-5; the parameters after 3 steps are held
    to 1e-4, a third of what 3 Adam steps at lr 1e-4 can move one."""
    jt, pt = _trainers(model_type, heads)
    leaf = "class_maps" if model_type == "multi_class_bottomup" else "class_vectors"
    jhead = getattr(jt.config.model_config.head_configs, model_type)
    phead = getattr(pt.config.model_config.head_configs, model_type)
    assert getattr(phead, leaf).classes == getattr(jhead, leaf).classes == ["id0", "id1", "id2"]
    assert pt.config.data_config.preprocessing.crop_size == \
        jt.config.data_config.preprocessing.crop_size
    assert pt._input_shape == tuple(jt._input_shape)
    jbatches, pbatches = list(jt.train_loader._gen()), list(pt.train_loader._gen())
    assert len(jbatches) == len(pbatches) >= 3
    batches = jbatches[-3:]
    assert not batches[-1]["batch_mask"].all()  # a padded batch
    params, opt_state = jt.params, jt.tx.init(jt.params)
    copy_ = lambda t: jax.tree_util.tree_map(lambda x: x.copy(), t)  # noqa: E731 (donated)
    for step, batch in enumerate(batches):
        jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
        if step == 0:
            want_grads = flax_to_torch_state(jax.device_get(_jax_grads(jt, jbatch)), pt.model)
        params, opt_state, want_loss, want_parts = jt._train_step(
            copy_(params), copy_(opt_state), jbatch, jax.random.PRNGKey(step))
        got_loss, got_parts = pt.train_step(batch)
        np.testing.assert_allclose(got_loss.item(), float(want_loss), rtol=1e-5)
        _assert_parts_close(got_parts, want_parts, rtol=1e-5 if step == 0 else 1e-4)
        if model_type == "multi_class_topdown":
            assert "class_accuracy" in got_parts
        if step == 0:
            for name, p in pt.model.named_parameters():
                scale = want_grads[name].abs().max().item()
                err = (p.grad - want_grads[name]).abs().max().item()
                assert err <= 1e-4 * scale, (name, err, scale)
        if step in (0, 2):
            atol = 1e-5 if step == 0 or model_type == "multi_class_bottomup" else 1e-4
            want_params = flax_to_torch_state(jax.device_get(params), pt.model)
            for name, p in pt.model.state_dict().items():
                torch.testing.assert_close(p, want_params[name], rtol=0, atol=atol,
                                           msg=f"step {step}: {name}")
    vbatch = next(iter(jt.val_loader))
    want_val, want_vparts = jt._val_step(params, {k: jnp.asarray(v) for k, v in vbatch.items()})
    got_val, got_vparts = pt.val_step(vbatch)
    np.testing.assert_allclose(got_val.item(), float(want_val), rtol=1e-5)
    _assert_parts_close(got_vparts, want_vparts, rtol=1e-4)


def _eval_callback(trainer):
    return next(cb for cb in trainer.callbacks if type(cb).__name__ == "EpochEndEvaluationCallback")


@pytest.mark.parametrize("model_type", TYPES)
def test_epoch_logs_and_epoch_end_eval_match_jax(model_type):
    """One epoch of 3 steps with ``eval.enabled``: every log but the clocks
    matches the JAX trainer's (``class_accuracy`` of multi-class top-down
    included) to 1e-5; a multi-class top-down model is evaluated as a
    centered-instance one (``val/mOKS``, ``val/dist.avg``), a bottom-up one
    adds nothing. With 1 added to the confmap head's bias in both, the
    callbacks give the same metrics on the same weights."""
    jt, pt = _trainers(model_type, eval={"enabled": True}, max_epochs=1,
                       train_steps_per_epoch=3)
    jt.train()
    pt.train()
    clocks = {"train/steps_per_sec", "train/samples_per_sec", "epoch_time_s"}
    want = {k: v for k, v in jt.history[-1].items() if k not in clocks}
    got = {k: v for k, v in pt.history[-1].items() if k not in clocks}
    assert set(got) == set(want)
    for k in want:
        tight = k.endswith("/loss") or "class_accuracy" in k or k.startswith("val/") and (
            "mOKS" in k or "dist" in k) or k == "learning_rate"
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5 if tight else 1e-4, atol=1e-9,
                                   err_msg=k)
    expected = {"multi_class_topdown": {"val/mOKS", "val/dist.avg"},
                "multi_class_bottomup": set()}[model_type]
    if model_type == "multi_class_topdown":
        assert {"train/class_accuracy", "val/class_accuracy"} <= set(got)
    head = next(h.name for h in pt.model.heads if "Confmaps" in h.name)
    with torch.no_grad():
        next(layer[head][0] for layer in pt.model.head_layers if head in layer).bias.add_(1.0)
    params = jax.tree_util.tree_map(np.asarray, jax.device_get(jt.params))
    params["params"][head]["head_conv"]["bias"] = params["params"][head]["head_conv"]["bias"] + 1
    jt.params = params
    want, got = _eval_callback(jt)._evaluate(jt), _eval_callback(pt)._evaluate(pt)
    assert set(got) == set(want) == expected
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


def test_crop_models_leave_out_negative_frames_like_jax():
    d = _cfg("multi_class_topdown")
    d["data_config"]["use_negative_frames"] = True
    jt = JTrainer.get_model_trainer_from_config(JConfig.from_dict(d), [id_labels(jio)])
    with pytest.warns(UserWarning, match="Negative frames will be disabled") as jwarn:
        jt.setup()
    pt = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [id_labels(pio)],
                                                    device="cpu")
    with pytest.warns(UserWarning, match="Negative frames will be disabled") as pwarn:
        pt.setup()
    assert [str(w.message) for w in pwarn if "Negative" in str(w.message)] == \
        [str(w.message) for w in jwarn if "Negative" in str(w.message)]
    assert len(pt.train_ds) == len(jt.train_ds)


@pytest.mark.parametrize("model_type,heads", TRAIN_CASES)
def test_train_on_cpu_writes_a_loadable_model_dir(model_type, heads, tmp_path):
    d = _cfg(model_type, heads=heads, augment=True, max_epochs=1, train_steps_per_epoch=2,
             save_ckpt=True, ckpt_dir=str(tmp_path), run_name="run")
    trainer = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), [id_labels(pio)],
                                                         device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the skeleton has no symmetries to flip
        trainer.train()
    assert np.isfinite(trainer.history[0]["train/loss"])
    loaded = load_model(tmp_path / "run")
    assert loaded.model_type == model_type
    want = ModelTrainer.load_checkpoint_params(tmp_path / "run" / "best.ckpt")
    got = loaded.model.state_dict()
    assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)


# --- the layers ---------------------------------------------------------------

UNET = UNetConfig(in_channels=1, filters=4, filters_rate=1.5, max_stride=8, output_stride=2)
NAMES = [f"n{i}" for i in range(N_NODES)]
CLASSES = ["a", "b", "c"]
CROP, MAX_INST = 32, 3


def _layer_heads(model_type):
    if model_type == "centroid":
        return ns(confmaps=ns(anchor_part=None, sigma=5.0, output_stride=2, loss_weight=None))
    cm = ns(part_names=NAMES, anchor_part=None, sigma=2.5, output_stride=2, loss_weight=None)
    if model_type == "multi_class_bottomup":
        return ns(confmaps=cm, class_maps=ns(classes=CLASSES, sigma=3.0, output_stride=4,
                                             loss_weight=None))
    return ns(confmaps=cm, class_vectors=ns(classes=CLASSES, num_fc_layers=1, num_fc_units=16,
                                            global_pool=True, output_stride=1,
                                            loss_weight=None))


def _model_pair(model_type, frames, seed, tied=False):
    """Flax and torch models with the same weights: the confmap head moved
    onto [0, 1] per channel over ``frames`` (biases zero elsewhere, as flax
    initialises them); with ``tied``, a class-map head of zeros (every
    class probability exactly 0.5)."""
    heads = _layer_heads(model_type)
    fmodel = FlaxModel.from_config("unet", UNET, heads, model_type)
    params = fmodel.init(jax.random.PRNGKey(seed), jnp.zeros((1, HW, HW, 1), jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, params)
    name = next(k for k in params["params"] if "Confmaps" in k)
    head = params["params"][name]["head_conv"]
    maps = np.asarray(fmodel.apply(params, jnp.asarray(frames / 255.0, jnp.float32))[name])
    top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
    head["kernel"] = (head["kernel"] / (top - bottom)).astype(np.float32)
    head["bias"] = (-bottom / (top - bottom)).astype(np.float32)
    if tied:
        cmaps = params["params"]["ClassMapsHead"]["head_conv"]
        cmaps["kernel"] = np.zeros_like(cmaps["kernel"])
    tmodel = Model.from_config("unet", UNET, heads, model_type, input_hw=(CROP, CROP))
    return fmodel, params, tmodel, flax_to_torch_state(params, tmodel)


PRE = dict(ensure_grayscale=True, max_stride=8)


def _bottomup_layers(frames, tied):
    fmodel, params, tmodel, state = _model_pair("multi_class_bottomup", frames, 0, tied)
    post = dict(peak_threshold=0.2, max_peaks=40)
    kw = dict(n_nodes=N_NODES, n_classes=N_CLASSES, cm_output_stride=2,
              class_maps_output_stride=4)
    jlayer = jl.BottomUpMultiClassLayer(JaxBackend(fmodel, params), jl.PreprocessConfig(**PRE),
                                        jl.PostprocessConfig(**post), **kw)
    tlayer = tl.BottomUpMultiClassLayer(
        TorchBackend(tmodel, state, fused_convs=True, device="cpu"), tl.PreprocessConfig(**PRE),
        tl.PostprocessConfig(**post), device="cpu", **kw)
    return jlayer, tlayer


def _topdown_layers(frames):
    cm, cp, ctm, csd = _model_pair("centroid", frames, 0)
    im, ip, itm, isd = _model_pair("multi_class_topdown", frames, 1)
    post = dict(peak_threshold=0.2, max_instances=MAX_INST)
    jlayer = jl.TopDownMultiClassLayer(
        jl.CentroidLayer(JaxBackend(cm, cp), jl.PreprocessConfig(**PRE),
                         jl.PostprocessConfig(**post), output_stride=2),
        jl.CenteredInstanceLayer(JaxBackend(im, ip), jl.PreprocessConfig(**PRE),
                                 jl.PostprocessConfig(peak_threshold=0.2), output_stride=2),
        max_instances=MAX_INST, crop_size=CROP, n_classes=N_CLASSES)
    tlayer = tl.TopDownMultiClassLayer(
        tl.CentroidLayer(TorchBackend(ctm, csd, fused_convs=True, device="cpu"),
                         tl.PreprocessConfig(**PRE), tl.PostprocessConfig(**post),
                         output_stride=2, device="cpu"),
        tl.CenteredInstanceLayer(TorchBackend(itm, isd, fused_convs=True, device="cpu"),
                                 tl.PreprocessConfig(**PRE),
                                 tl.PostprocessConfig(peak_threshold=0.2), output_stride=2,
                                 device="cpu"),
        max_instances=MAX_INST, crop_size=CROP, n_classes=N_CLASSES, device="cpu")
    return jlayer, tlayer


def _compare(got, want, atol):
    assert set(got) == set(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        if w.dtype == bool or np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
            np.testing.assert_allclose(g, w.astype(np.float32), atol=atol, rtol=0, err_msg=k)


@pytest.mark.parametrize("tied", [False, True])
def test_bottomup_multiclass_layer_matches_jax(tied):
    frames = blob_frames(4, seed=3)
    jlayer, tlayer = _bottomup_layers(frames, tied)
    dev = tlayer.predict_async(frames)
    # The class probabilities come back gathered per peak, not as maps.
    assert dev["peak_class_probs"].shape == (4, 40, N_CLASSES)
    assert not any(v.ndim == 4 for v in dev.values() if torch.is_tensor(v))
    want, got = jlayer.predict(frames), tlayer.finalize(dev)
    _compare(got, want, atol=1e-5)
    found = np.isfinite(want["pred_keypoints"]).all(-1)
    assert found.sum() >= 6  # several nodes of several classes assigned
    if tied:
        probs = want["pred_class_probs"]
        assert (probs[np.isfinite(probs)] == 0.5).all()


def test_topdown_multiclass_layer_matches_jax():
    frames = blob_frames(4, seed=3)
    jlayer, tlayer = _topdown_layers(frames)
    want, got = jlayer.predict(frames), tlayer.predict(frames)
    _compare(got, want, atol=1e-4)
    valid = want["instance_valid"]
    assert valid.sum() >= 4
    inds = want["pred_class_inds"]
    assert (inds[valid] >= 0).all() and (inds[~valid] == -1).all()
    for row, keep in zip(inds, valid):  # distinct classes within a frame
        assert len(set(row[keep].tolist())) == keep.sum()


# --- model dirs ---------------------------------------------------------------

DIR_TYPES = ("centroid", "multi_class_bottomup", "multi_class_topdown")
TYPE_SETS = {"multi_class_bottomup": ("multi_class_bottomup",),
             "multi_class_topdown": ("centroid", "multi_class_topdown")}
N_FRAMES = 7


def _dir_config(model_type, root):
    d = cfg_dict(batch=2, max_epochs=1, train_steps_per_epoch=1, save_ckpt=True,
                 ckpt_dir=str(root), run_name=model_type, model_ckpt={"save_last": True})
    if model_type != "centroid":
        d["model_config"]["head_configs"] = {model_type: head_configs(model_type)}
    if model_type == "multi_class_topdown":
        d["data_config"]["preprocessing"] = {"crop_size": CROP}
    return d


def _condition(model, frames):
    """Zero every bias; move each confmap head channel onto [0, 1] over the
    frames (as ``tests/test_torch_model_dir.py`` conditions a bottom-up head)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
        model.eval()
        out = model(torch.from_numpy(frames / np.float32(255.0)))
        for layer in model.head_layers:
            for head, module in layer.items():
                if "Confmaps" in head:
                    maps = out[head].numpy()
                    top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
                    module[0].weight.div_(torch.from_numpy(top - bottom)[:, None, None, None])
                    module[0].bias.copy_(torch.from_numpy(-bottom / (top - bottom)))


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Per model type: a dir trained one step by the port, then conditioned
    and saved by its trainer; and the trainer."""
    root = tmp_path_factory.mktemp("runs")
    frames = blob_frames(N_FRAMES + 1, seed=2)
    out = {}
    for mt in DIR_TYPES:
        labels = id_labels(pio, frames=frames, max_inst=2, seed=2, spread=4)
        trainer = ModelTrainer.get_model_trainer_from_config(
            PConfig.from_dict(_dir_config(mt, root)), [labels], device="cpu")
        trainer.train()
        _condition(trainer.model, frames)
        trainer.save_checkpoint("best.ckpt")
        out[mt] = ns(path=trainer.ckpt_dir, trainer=trainer)
    return out


def _paths(dirs, type_set):
    return [dirs[mt].path for mt in TYPE_SETS[type_set]]


def _video():
    return FrameVideo(blob_frames(N_FRAMES, seed=9))


def _in_memory_layer(dirs, type_set):
    pre = tl.PreprocessConfig(ensure_grayscale=True, max_height=HW, max_width=HW, max_stride=8)
    post = tl.PostprocessConfig(peak_threshold=0.2)
    backend = lambda mt: TorchBackend(dirs[mt].trainer.model, None, device="cpu")  # noqa: E731
    if type_set == "multi_class_bottomup":
        return tl.BottomUpMultiClassLayer(backend(type_set), pre, post, n_nodes=N_NODES,
                                          n_classes=N_CLASSES, class_maps_output_stride=4,
                                          device="cpu")
    post_c = tl.PostprocessConfig(peak_threshold=0.2, max_instances=20)
    return tl.TopDownMultiClassLayer(
        tl.CentroidLayer(backend("centroid"), pre, post_c, device="cpu"),
        tl.CenteredInstanceLayer(backend("multi_class_topdown"), pre, post, device="cpu"),
        max_instances=20, crop_size=CROP, n_classes=N_CLASSES, device="cpu")


def _assert_same(got, want, atol=None):
    assert len(got) == len(want)
    for g_out, w_out in zip(got, want):
        assert set(g_out) == set(w_out)
        for key in w_out:
            g, w = np.asarray(g_out[key]), np.asarray(w_out[key])
            assert g.shape == w.shape, key
            if atol is None or w.dtype.kind in "biu":
                np.testing.assert_array_equal(g, w, err_msg=key)
            else:
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
                np.testing.assert_allclose(g, w.astype(g.dtype), atol=atol, rtol=0, err_msg=key)


def _track_names(labels):
    return [[i.track.name if i.track is not None else None for i in lf.instances]
            for lf in labels]


def _tracked(labels):
    return sum(inst.track is not None for lf in labels for inst in lf.instances)


@pytest.mark.parametrize("type_set", TYPE_SETS)
def test_dir_predictions_equal_the_in_memory_model(dirs, type_set):
    video = _video()
    got = prun.predict(video, _paths(dirs, type_set), batch_size=4, device="cpu",
                       make_labels=False)
    want = Predictor(_in_memory_layer(dirs, type_set), type_set, None, [], batch_size=4,
                     device="cpu").predict(video, make_labels=False)
    _assert_same(got, want)
    assert np.isfinite(np.concatenate([o["pred_keypoints"] for o in got])).any()


@pytest.mark.parametrize("type_set", TYPE_SETS)
def test_dir_predictions_match_the_jax_package(dirs, type_set):
    video = _video()
    paths = _paths(dirs, type_set)
    got = prun.predict(video, paths, batch_size=4, device="cpu", make_labels=False)
    jp = JaxPredictor.from_model_paths(paths, batch_size=4)
    want = jp.predict(video, provider=JaxVideoProvider(video, batch_size=4), make_labels=False)
    _assert_same(got, want, atol=1e-5 if type_set == "multi_class_bottomup" else 1e-4)


def _assert_same_labels(got, want, atol):
    """Frames in order; instances with the same points, scores, track name
    and tracking score; the same tracks in the same order."""
    assert [t.name for t in got.tracks] == [t.name for t in want.tracks]
    assert len(got.labeled_frames) == len(want.labeled_frames)
    for g, w in zip(got.labeled_frames, want.labeled_frames):
        assert g.frame_idx == w.frame_idx and len(g.instances) == len(w.instances)
        for gi, wi in zip(g.instances, w.instances):
            np.testing.assert_array_equal(np.isnan(gi.points), np.isnan(wi.points))
            np.testing.assert_allclose(gi.points, wi.points, atol=atol, rtol=0)
            np.testing.assert_allclose(gi.point_scores, wi.point_scores, atol=atol, rtol=0)
            np.testing.assert_allclose(gi.score, wi.score, atol=atol, rtol=0)
            assert (gi.track and gi.track.name) == (wi.track and wi.track.name)
            np.testing.assert_allclose(gi.tracking_score, wi.tracking_score, atol=atol, rtol=0)
        names = [i.track.name for i in g.instances if i.track is not None]
        assert len(names) == len(set(names))  # no frame holds a track twice


@pytest.mark.parametrize("type_set", TYPE_SETS)
def test_run_predict_labels_match_the_jax_package(dirs, type_set):
    frames = blob_frames(N_FRAMES, seed=9)
    labels_p = pio.Labels([pio.LabeledFrame(FrameVideo(frames), i) for i in range(N_FRAMES)])
    labels_j = jio.Labels([jio.LabeledFrame(FrameVideo(frames), i) for i in range(N_FRAMES)])
    paths = _paths(dirs, type_set)
    got = prun.predict(labels_p, paths, batch_size=4, device="cpu")
    want = jax_predict(labels_j, paths, batch_size=4)
    _assert_same_labels(got, want, atol=1e-5 if type_set == "multi_class_bottomup" else 1e-4)
    assert _tracked(got) >= 3
    assert {t.name for t in got.tracks} <= {"id0", "id1", "id2"}
    assert got.provenance["model_type"] == want.provenance["model_type"] == type_set


def test_slp_keeps_the_class_tracks(dirs, tmp_path):
    from sleap_nn_tpu.io.slp import load_slp as jax_load_slp
    from sleap_nn_tpu_torch.io.slp import load_slp

    frames = blob_frames(N_FRAMES, seed=9)
    labels = pio.Labels([pio.LabeledFrame(FrameVideo(frames), i) for i in range(N_FRAMES)])
    rows = {}
    for type_set in TYPE_SETS:
        out = tmp_path / f"{type_set}.slp"
        got = prun.predict(labels, _paths(dirs, type_set), batch_size=4, device="cpu",
                           output_path=out, embed=True)
        want = _track_names(got)
        for back in (load_slp(out), jax_load_slp(out)):
            assert _track_names(back) == want
            assert [t.name for t in back.tracks] == [t.name for t in got.tracks]
        rows[type_set] = want
    assert all(sum(n is not None for r in v for n in r) >= 3 for v in rows.values())


def test_from_model_paths_builds_the_identity_layers(dirs):
    bu = Predictor.from_model_paths(_paths(dirs, "multi_class_bottomup"), device="cpu")
    td = Predictor.from_model_paths(_paths(dirs, "multi_class_topdown"), device="cpu",
                                    crop_size=30)
    assert isinstance(bu.layer, tl.BottomUpMultiClassLayer)
    assert (bu.layer.class_maps_output_stride, bu.layer.n_nodes) == (4, N_NODES)
    assert isinstance(td.layer, tl.TopDownMultiClassLayer)
    assert td.layer.crop_size == 32  # rounded up to the max stride
    assert bu.class_names == td.class_names == ["id0", "id1", "id2"]
    with pytest.raises(ValueError, match="Unsupported model type combination"):
        Predictor.from_model_paths([dirs["multi_class_topdown"].path,
                                    dirs["multi_class_bottomup"].path], device="cpu")
