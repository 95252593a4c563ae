"""Port parity: the centroid training data pipeline against the JAX package.

The same labels (numpy-made frames and points, from a seed) are built in
both packages' data models; each stage runs in both on the CPU.
Tolerances: host-side values (samples, splits, batches, contexts) exactly;
the device render (augmentation off) to 1e-6 absolute (images are the same
f32 arithmetic; the confmaps are ``exp`` of the same f32 arguments).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.data import instance_centroids as jcent
from sleap_nn_tpu.data import pipeline as jpipe
from sleap_nn_tpu.data import providers as jprov
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.data import instance_centroids as pcent
from sleap_nn_tpu_torch.data import pipeline as ppipe
from sleap_nn_tpu_torch.data import providers as pprov
from sleap_nn_tpu_torch.io import model as pio


class ArrayVideo:
    """Duck-typed in-memory video: ``video[i]`` and ``.shape``."""

    def __init__(self, frames):
        self.frames = frames
        self.shape = frames.shape

    def __getitem__(self, idx):
        return self.frames[idx]


def make_labels(io, n_frames=12, hw=(64, 64), n_nodes=3, max_inst=3, seed=0,
                symmetries=(), with_predicted=False):
    """Labels in ``io``'s data model (the JAX package's or the port's) from a
    numpy seed: random uint8 frames, 1..max_inst instances with some NaN and
    some out-of-bounds nodes, optionally a predicted instance per frame."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, (n_frames, *hw, 1), dtype=np.uint8)
    video = ArrayVideo(frames)
    skel = io.Skeleton([f"n{i}" for i in range(n_nodes)],
                       edges=[(i, i + 1) for i in range(n_nodes - 1)], symmetries=symmetries)
    lfs = []
    for f in range(n_frames):
        insts = []
        for _ in range(int(rng.integers(1, max_inst + 1))):
            pts = rng.uniform(-2, max(hw) + 2, (n_nodes, 2))
            pts[rng.random(n_nodes) < 0.2] = np.nan
            insts.append(io.Instance(pts, skel))
        if with_predicted:
            insts.append(io.PredictedInstance(rng.uniform(0, min(hw), (n_nodes, 2)), skel))
        lfs.append(io.LabeledFrame(video, f, insts))
    return io.Labels(lfs)


def head_configs(model_type="centroid", anchor=None):
    """The head config of one model type (confmaps sigma 2.5 at stride 2;
    PAFs sigma 5 at stride 4), as a plain dict."""
    cm = {"sigma": 2.5, "output_stride": 2}
    return {
        "single_instance": {"confmaps": cm},
        "centroid": {"confmaps": {"anchor_part": anchor, **cm}},
        "centered_instance": {"confmaps": {"anchor_part": anchor, **cm}},
        "bottomup": {"confmaps": cm, "pafs": {"sigma": 5.0, "output_stride": 4}},
    }[model_type]


def cfg_dict(augment=False, anchor=None, batch=4, model_type="centroid", **trainer):
    """A training config as a plain dict (both packages' schema); a centroid
    model unless ``model_type`` names another."""
    d = {
        "data_config": {
            "validation_fraction": 0.25,
            "use_augmentations_train": augment,
            "augmentation_config": {"geometric": {}} if augment else None,
        },
        "model_config": {
            "backbone_config": {"unet": {"filters": 8, "filters_rate": 1.5, "max_stride": 8,
                                         "output_stride": 2}},
            "head_configs": {model_type: head_configs(model_type, anchor)},
        },
        "trainer_config": {
            "max_epochs": 2, "train_steps_per_epoch": 2, "save_ckpt": False, "seed": 7,
            "enable_progress_bar": False,
            "train_data_loader": {"batch_size": batch}, "val_data_loader": {"batch_size": batch},
            **trainer,
        },
    }
    return d


def _frame_inds(labels):
    return [lf.frame_idx for lf in labels.labeled_frames]


@pytest.mark.parametrize("n_train,n_val,n_test,seed", [
    (0.8, 0.2, None, 0), (0.5, None, None, 3), (5, 3, 2, 11), (0.7, 0.1, 0.2, 42)])
def test_make_training_splits_identical(n_train, n_val, n_test, seed):
    jl, pl = make_labels(jio, n_frames=15), make_labels(pio, n_frames=15)
    a = jl.make_training_splits(n_train, n_val, n_test, seed=seed)
    b = pl.make_training_splits(n_train, n_val, n_test, seed=seed)
    assert [_frame_inds(x) for x in a] == [_frame_inds(x) for x in b]


@pytest.mark.parametrize("user_only", [True, False])
def test_process_lf_matches(user_only):
    jl = make_labels(jio, with_predicted=True, max_inst=4)
    pl = make_labels(pio, with_predicted=True, max_inst=4)
    assert jprov.get_max_instances(jl) == pprov.get_max_instances(pl)
    assert jprov.get_max_height_width(jl) == pprov.get_max_height_width(pl)
    tj = {id(t): i for i, t in enumerate(jl.tracks)}
    tp = {id(t): i for i, t in enumerate(pl.tracks)}
    for lfj, lfp in zip(jl.labeled_frames, pl.labeled_frames):
        a = jprov.process_lf(lfj, 0, 3, user_instances_only=user_only, track_index=tj)
        b = pprov.process_lf(lfp, 0, 3, user_instances_only=user_only, track_index=tp)
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("anchor", [None, 1])
def test_generate_centroids_matches(anchor):
    rng = np.random.default_rng(anchor or 0)
    pts = rng.uniform(0, 50, (3, 4, 5, 2)).astype(np.float32)
    pts[rng.random((3, 4, 5)) < 0.3] = np.nan
    pts[0, 1] = np.nan  # an all-NaN instance
    pts[1, 2, 1] = np.nan  # anchor missing: the mean is used
    want = np.asarray(jcent.generate_centroids(jnp.asarray(pts), anchor))
    got = pcent.generate_centroids(torch.from_numpy(pts), anchor).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))


@pytest.mark.parametrize("augment,anchor", [(False, None), (True, "n1")])
def test_build_pipeline_context_matches(augment, anchor):
    d = cfg_dict(augment=augment, anchor=anchor)
    jl = make_labels(jio, symmetries=[(0, 2)])
    pl = make_labels(pio, symmetries=[(0, 2)])
    jctx = jpipe.build_pipeline_context(JConfig.from_dict(d), jl, "centroid")
    pctx = ppipe.build_pipeline_context(PConfig.from_dict(d), pl, "centroid")
    for f in dataclasses.fields(pctx):
        assert getattr(pctx, f.name) == getattr(jctx, f.name), f.name


def _datasets(batch=4, shuffle=True):
    jl, pl = make_labels(jio, n_frames=11), make_labels(pio, n_frames=11)
    d = cfg_dict()
    jctx = jpipe.build_pipeline_context(JConfig.from_dict(d), jl, "centroid")
    pctx = ppipe.build_pipeline_context(PConfig.from_dict(d), pl, "centroid")
    jds = jpipe.make_dataset("centroid", [jl], jctx)
    pds = ppipe.make_dataset("centroid", [pl], pctx)
    return (jctx, jds, jpipe.Loader(jds, batch, shuffle=shuffle, seed=5, prefetch=0),
            pctx, pds, ppipe.Loader(pds, batch, shuffle=shuffle, seed=5, prefetch=2))


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_identical_batches(shuffle):
    _, jds, jload, _, pds, pload = _datasets(shuffle=shuffle)
    assert len(jds) == len(pds) and len(jload) == len(pload)
    for epoch in (0, 1, 3003):
        jload.set_epoch(epoch)
        pload.set_epoch(epoch)
        jb, pb = list(jload), list(pload)
        assert len(jb) == len(pb) == 3
        for a, b in zip(jb, pb):
            assert set(a) == set(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        assert pb[-1]["batch_mask"].tolist() == [True, True, True, False]


def test_make_render_fn_centroid_matches():
    jctx, jds, _, pctx, pds, _ = _datasets()
    batch = jds.make_batch([0, 3, 5, 10])
    pbatch = pds.make_batch([0, 3, 5, 10])
    want = jpipe.make_render_fn(jctx, train=False)({k: jnp.asarray(v) for k, v in batch.items()})
    got = ppipe.make_render_fn(pctx, train=False)(
        {k: torch.from_numpy(v) for k, v in pbatch.items()})
    for k in ("image", "instances", "centroids", "confmaps"):
        w, g = np.asarray(want[k]), got[k].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, k
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
    assert got["confmaps"].shape == (4, 32, 32, 1)
    assert got["confmaps"].max() > 0.9  # the targets are not empty


def test_make_render_fn_sizematch_and_scale():
    """Max dims above the frame (sizematch pads) and a 0.5 input scale."""
    jl, pl = make_labels(jio, hw=(60, 52)), make_labels(pio, hw=(60, 52))
    d = cfg_dict()
    d["data_config"]["preprocessing"] = {"max_height": 72, "max_width": 80, "scale": 0.5}
    jctx = jpipe.build_pipeline_context(JConfig.from_dict(d), jl, "centroid")
    pctx = ppipe.build_pipeline_context(PConfig.from_dict(d), pl, "centroid")
    batch = jpipe.make_dataset("centroid", [jl], jctx).make_batch([1, 2])
    want = jpipe.make_render_fn(jctx, train=False)({k: jnp.asarray(v) for k, v in batch.items()})
    got = ppipe.make_render_fn(pctx, train=False)({k: torch.from_numpy(v) for k, v in batch.items()})
    assert want["eff_scale"] == got["eff_scale"]
    for k in ("image", "centroids", "confmaps"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=0, atol=1e-5,
                                   err_msg=k)


def test_other_model_types_raise():
    _, _, _, pctx, _, _ = _datasets()
    with pytest.raises(NotImplementedError, match="item 10"):
        ppipe.make_render_fn(dataclasses.replace(pctx, model_type="bottomup_segmentation"),
                             train=True)
    with pytest.raises(NotImplementedError, match="item 10"):
        ppipe.make_dataset("centered_instance_segmentation", [], pctx)
