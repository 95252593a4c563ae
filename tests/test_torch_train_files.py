"""Port parity: training from label files and the post-training evaluation
(``training/model_trainer.py``, ``train.py``) against the JAX package.

Both trainers read the same files on the CPU: a ``.pkg.slp`` with embedded
frames and a ``.slp`` that references an MJPG clip written here with cv2
(gray content in three equal channels). The loaded splits, loader batches
and, from the same initial parameters, 3 Adam steps agree within the
tolerances of ``tests/test_torch_model_types.py``: losses to 1e-5
relative, parameters to 1e-5 absolute. Each of the three video path
remappings gives the JAX trainer's paths and frames; an empty file raises
the JAX ``ValueError``. ``run_training`` writes the JAX trainer's model-dir
file set (with ``test_file_path``); the JAX package reads its ``.slp`` and
metrics files. The post-training evaluation predicts at threshold -1e9 in
both packages here, so that the briefly trained models emit predictions.
With h5py blocked, every ``.slp`` file of the model dir is still written
(the port's own HDF5 writer) and no warning is raised.
"""

import copy
import functools
import sys
import warnings

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from sleap_nn_tpu import train as jtrain
from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.evaluation import load_metrics as jax_load_metrics
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.io import video as jvideo
from sleap_nn_tpu.io.slp import load_slp as jax_load_slp
from sleap_nn_tpu.training import ModelTrainer as JTrainer
from sleap_nn_tpu_torch import train as ptrain
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io.slp import load_slp as port_load_slp
from sleap_nn_tpu_torch.training import ModelTrainer
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_model_dir import FrameVideo, blob_frames
from tests.test_torch_pipeline import cfg_dict
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

HW, N = 64, 12


def _labels(io, video, n=N, seed=3):
    """1-3 three-node instances a frame on ``video``; frame 5 is empty."""
    rng = np.random.default_rng(seed)
    skel = io.Skeleton(["n0", "n1", "n2"], edges=[(0, 1), (1, 2)])
    lfs = []
    for f in range(n):
        insts = [] if f == 5 else [
            io.Instance(rng.uniform(12, HW - 12, 2) + rng.normal(0, 4, (3, 2)), skel)
            for _ in range(int(rng.integers(1, 4)))]
        lfs.append(io.LabeledFrame(video, f, insts))
    return io.Labels(lfs, videos=[video], skeletons=[skel])


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``emb.pkg.slp`` (embedded frames), ``clip.avi`` (MJPG) with
    ``clip.slp`` referencing it, ``moved.slp`` referencing the clip by a
    name that exists nowhere (so that the loaders' search beside the
    ``.slp`` file finds nothing), and ``empty.slp``."""
    root = tmp_path_factory.mktemp("files")
    frames = blob_frames(N, seed=4)
    _labels(jio, FrameVideo(frames, "frames.mp4")).save(root / "emb.pkg.slp", embed=True)
    writer = cv2.VideoWriter(str(root / "clip.avi"), cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                             (HW, HW))
    assert writer.isOpened()
    for f in frames:
        writer.write(np.repeat(f, 3, axis=-1))
    writer.release()
    _labels(jio, jvideo.Video(str(root / "clip.avi"))).save(root / "clip.slp")
    _labels(jio, jvideo.Video("/nowhere/media/gone.avi")).save(root / "moved.slp")
    jio.Labels([], skeletons=[jio.Skeleton(["n0"])]).save(root / "empty.slp")
    return root


def _cfg(root, train, val=None, model_type="centroid", **trainer):
    d = cfg_dict(model_type=model_type, batch=2, **trainer)
    d["data_config"]["train_labels_path"] = [str(root / p) for p in train]
    if val:
        d["data_config"]["val_labels_path"] = [str(root / p) for p in val]
    return d


def _trainers(d):
    jt = JTrainer.get_model_trainer_from_config(JConfig.from_dict(copy.deepcopy(d)))
    pt = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(copy.deepcopy(d)),
                                                    device="cpu")
    return jt, pt


def _frames_of(labels_list):
    return [(lf.frame_idx, np.asarray(lf.image)) for L in labels_list for lf in L]


def _assert_same_splits(jt, pt):
    for js, ps in ((jt.train_labels, pt.train_labels), (jt.val_labels, pt.val_labels)):
        jf, pf = _frames_of(js), _frames_of(ps)
        assert [f for f, _ in jf] == [f for f, _ in pf] and jf
        for (_, a), (_, b) in zip(jf, pf):
            np.testing.assert_array_equal(a, b)


def _three_steps(jt, pt):
    """Loader batches equal; 3 steps from the same parameters alike."""
    jt.setup()
    pt.setup()
    pt.model.load_state_dict(flax_to_torch_state(jax.device_get(jt.params), pt.model),
                             strict=True)
    jb, pb = list(jt.train_loader._gen()), list(pt.train_loader._gen())
    assert len(jb) == len(pb) >= 3
    for a, b in zip(jb, pb):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    params, opt_state = jt.params, jt.tx.init(jt.params)
    copy_ = lambda t: jax.tree_util.tree_map(lambda x: x.copy(), t)  # noqa: E731
    for step, batch in enumerate(jb[:3]):
        params, opt_state, want, _ = jt._train_step(
            copy_(params), copy_(opt_state), {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(step))
        got, _ = pt.train_step(batch)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    want_params = flax_to_torch_state(jax.device_get(params), pt.model)
    for name, p in pt.model.state_dict().items():
        torch.testing.assert_close(p, want_params[name], rtol=0, atol=1e-5, msg=name)
    vbatch = next(iter(jt.val_loader))
    want_val, _ = jt._val_step(params, {k: jnp.asarray(v) for k, v in vbatch.items()})
    got_val, _ = pt.val_step(vbatch)
    np.testing.assert_allclose(got_val.item(), float(want_val), rtol=1e-5)


@pytest.mark.parametrize("source", ["emb.pkg.slp", "clip.slp"])
def test_training_from_a_labels_file_matches_jax(files, source):
    jt, pt = _trainers(_cfg(files, [source], train_steps_per_epoch=3))
    _assert_same_splits(jt, pt)
    if source == "clip.slp":
        assert type(pt.train_labels[0].videos[0].backend).__name__ == "MediaVideoBackend"
    _three_steps(jt, pt)


def test_val_labels_path_matches_jax(files):
    jt, pt = _trainers(_cfg(files, ["emb.pkg.slp"], ["clip.slp"], train_steps_per_epoch=3))
    assert len(pt.val_labels[0]) == len(jt.val_labels[0]) == N
    _assert_same_splits(jt, pt)
    _three_steps(jt, pt)


@pytest.mark.parametrize("remap", ["video_paths", "video_path_map", "video_prefix_map"])
def test_video_path_remapping_matches_jax(files, remap):
    value = {"video_paths": [str(files / "clip.avi")],
             "video_path_map": {"/nowhere/media/gone.avi": str(files / "clip.avi")},
             "video_prefix_map": {"/nowhere/media/gone": str(files / "clip")}}[remap]
    d = _cfg(files, ["moved.slp"])
    d["data_config"][remap] = value
    jt, pt = _trainers(d)
    assert pt.train_labels[0].videos[0].filename == jt.train_labels[0].videos[0].filename \
        == str(files / "clip.avi")
    _assert_same_splits(jt, pt)


def test_unmapped_moved_video_fails_alike(files):
    d = _cfg(files, ["moved.slp"])
    with pytest.raises(FileNotFoundError, match="/nowhere/media/gone.avi"):
        JTrainer.get_model_trainer_from_config(JConfig.from_dict(copy.deepcopy(d)))
    with pytest.raises(FileNotFoundError, match="/nowhere/media/gone.avi"):
        ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), device="cpu")


def test_empty_labels_file_raises_like_jax(files):
    d = _cfg(files, ["empty.slp"])
    with pytest.raises(ValueError) as want:
        JTrainer.get_model_trainer_from_config(JConfig.from_dict(copy.deepcopy(d)))
    with pytest.raises(ValueError) as got:
        ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), device="cpu")
    assert str(got.value) == str(want.value)
    assert "Training labels file is empty" in str(got.value)


def test_no_labels_and_no_path_raises_like_jax():
    d = cfg_dict()
    with pytest.raises(ValueError, match="train_labels_path must be set"):
        JTrainer.get_model_trainer_from_config(JConfig.from_dict(copy.deepcopy(d)))
    with pytest.raises(ValueError, match="train_labels_path must be set"):
        ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(d), device="cpu")


def _run_cfg(files, root, **kw):
    d = _cfg(files, ["emb.pkg.slp"], max_epochs=1, train_steps_per_epoch=2, save_ckpt=True,
             ckpt_dir=str(root), run_name="run", **kw)
    d["data_config"]["test_file_path"] = str(files / "clip.slp")
    return d


@pytest.fixture
def low_threshold(monkeypatch):
    """Post-training predictions at threshold -1e9 in both packages."""
    for mod in (jtrain, ptrain):
        monkeypatch.setattr(mod, "_eval_split",
                            functools.partial(mod._eval_split, peak_threshold=-1e9))


def test_model_dir_file_set_matches_jax(files, tmp_path, low_threshold):
    d = _run_cfg(files, tmp_path / "jax")
    jtrain.run_training(JConfig.from_dict(copy.deepcopy(d)))
    d = _run_cfg(files, tmp_path / "port")
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)  # no warning
        trainer = ptrain.run_training(PConfig.from_dict(d), device="cpu")
    jdir, pdir = tmp_path / "jax" / "run", tmp_path / "port" / "run"
    names = {p.name for p in pdir.iterdir()}
    assert names == {p.name for p in jdir.iterdir()}
    assert {"labels_train_gt_0.slp", "labels_val_gt_0.slp", "labels_pr.test_0.slp",
            "metrics.test.0.npz", "metrics.val.0.npz"} <= names
    for name in sorted(n for n in names if n.endswith(".slp")):
        got, want = jax_load_slp(str(pdir / name)), jax_load_slp(str(jdir / name))
        assert len(got) == len(want), name
        if "_gt_" in name:  # the splits, frames embedded: equal pixels
            assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a.image, b.image)
                np.testing.assert_array_equal(a.numpy(), b.numpy())
    for split in ("train", "val", "test"):
        got, want = jax_load_metrics(str(pdir), split=split), jax_load_metrics(str(jdir),
                                                                               split=split)
        assert set(got) == set(want)
    # The metrics file holds what run_evaluation gives on the saved predictions.
    direct = ptrain.run_evaluation(trainer.val_labels[0],
                                   port_load_slp(str(pdir / "labels_pr.val_0.slp")),
                                   match_method="centroid")
    saved = jax_load_metrics(str(pdir), split="val")
    assert set(direct) <= set(saved)
    for k in ("distance_metrics", "detection_metrics"):
        for kk, v in direct[k].items():
            np.testing.assert_array_equal(np.asarray(saved[k][kk]), np.asarray(v), err_msg=kk)


def test_without_h5py_one_warning_and_the_metrics_only(files, tmp_path, monkeypatch,
                                                       low_threshold):
    """With h5py blocked the model dir is whole (the port writes ``.slp``
    through its own ``io/hdf5.py``): every split and every prediction file
    is written, loads equal to the split or to the recorded predictions, and
    no warning is raised."""
    frames = blob_frames(N, seed=4)
    labels = _labels(pio, FrameVideo(frames))
    d = cfg_dict(max_epochs=1, train_steps_per_epoch=2, save_ckpt=True,
                 ckpt_dir=str(tmp_path), run_name="run")
    monkeypatch.setitem(sys.modules, "h5py", None)  # import h5py raises ImportError
    recorded = {}
    evaluate = ptrain.run_evaluation

    def record(gt, preds, save_metrics=None, **kw):
        recorded[save_metrics.rsplit("metrics.", 1)[1].split(".")[0]] = preds
        return evaluate(gt, preds, save_metrics=save_metrics, **kw)

    monkeypatch.setattr(ptrain, "run_evaluation", record)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        trainer = ptrain.run_training(PConfig.from_dict(d), [labels], device="cpu")
    run = tmp_path / "run"
    names = {p.name for p in run.iterdir()}
    assert {"labels_train_gt_0.slp", "labels_val_gt_0.slp", "labels_pr.train_0.slp",
            "labels_pr.val_0.slp", "metrics.train.0.npz", "metrics.val.0.npz",
            "best.ckpt"} <= names
    for split, gt in (("train", trainer.train_labels[0]), ("val", trainer.val_labels[0])):
        got = port_load_slp(str(run / f"labels_{split}_gt_0.slp"))
        assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in gt]
        for a, b in zip(got, gt):
            np.testing.assert_array_equal(a.image, b.image)
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        got = port_load_slp(str(run / f"labels_pr.{split}_0.slp"))
        want = recorded[split]
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            assert a.frame_idx == b.frame_idx
            assert len(a.instances) == len(b.instances)
            for ia, ib in zip(a.instances, b.instances):
                np.testing.assert_array_equal(ia.numpy(), ib.numpy())
                np.testing.assert_array_equal(ia.point_scores, ib.point_scores)
                assert ia.score == ib.score


def test_train_from_a_config_path_matches_jax(files, tmp_path):
    d = _cfg(files, ["emb.pkg.slp"], max_epochs=3, trainer_accelerator="cpu")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(d))
    overrides = {"trainer_config.max_epochs": 2, "trainer_config.seed": 5}
    want = jtrain.train(config_path=str(path), overrides=overrides, train_steps_per_epoch=1,
                        train_labels_path=str(files / "clip.slp"))
    got = ptrain.train(config_path=str(path), overrides=overrides, train_steps_per_epoch=1,
                       train_labels_path=str(files / "clip.slp"))
    assert got.device.type == "cpu"
    assert len(got.history) == len(want.history) == 2
    for cfg in (got.config, want.config):
        assert cfg.trainer_config.seed == 5 and cfg.trainer_config.train_steps_per_epoch == 1
        assert cfg.data_config.train_labels_path == [str(files / "clip.slp")]
    _assert_same_splits(want, got)


def test_train_without_config_path_builds_it_from_keywords_like_jax(files):
    """``train()`` without ``config_path``: the keyword arguments (the
    reference's aliases ``backbone_config`` and ``geometry_aug`` among
    them) build the config through ``get_config``, then ``overrides``
    apply; the same config, splits and epochs as the JAX package's."""
    kwargs = dict(backbone_config={"unet": {"filters": 8, "max_stride": 8}},
                  head_configs={"centroid": {"confmaps": {"sigma": 2.5}}},
                  geometry_aug="rotation", ensure_grayscale=True, batch_size=2,
                  max_epochs=3, train_steps_per_epoch=1, trainer_accelerator="cpu",
                  overrides={"trainer_config.max_epochs": 2, "trainer_config.seed": 5})
    want = jtrain.train(str(files / "emb.pkg.slp"), **copy.deepcopy(kwargs))
    got = ptrain.train(str(files / "emb.pkg.slp"), **copy.deepcopy(kwargs))
    assert got.device.type == "cpu"
    assert len(got.history) == len(want.history) == 2
    assert got.config.to_dict() == want.config.to_dict()
    assert got.config.model_config.backbone_config.unet.filters == 8
    assert got.config.data_config.augmentation_config.geometric.affine_p == 1.0
    _assert_same_splits(want, got)
