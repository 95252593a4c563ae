"""Port parity: data-parallel inference (``data_parallel`` of
``Predictor.from_model_paths``, ``run.predict`` and ``--data-parallel``).

The JAX package shards each batch over its 8 virtual CPU devices
(``tests/conftest.py``); the port gives two replicas on the CPU
(``parallel.get_mesh(devices=["cpu", "cpu"])``) four rows each of a batch
of 8, and joins their outputs before the host step. On the same random-init
dirs (one training step, conditioned as ``tests/test_torch_model_dir.py``
conditions them) and blob frames:

- the port's two replicas give exactly the port's one device (the same
  CPU code on each row);
- both give the JAX package's data-parallel outputs with the tolerances of
  the dir tests: validity, counts, indices and NaN placement exact,
  keypoints and values to 1e-4 (1e-5 for the multi-class bottom-up
  model), masks bit for bit, segmentation centres to 5e-4 px.

Covered: every type set ``from_model_paths`` builds (single-instance,
centroid, top-down, bottom-up, both multi-class types, the three
segmentation types, a lone centered-instance model on ground-truth
centroids), and a short last batch (11 frames in batches of 8).
"""

from types import SimpleNamespace as ns

import numpy as np
import pytest
import torch

from sleap_nn_tpu.inference.predictor import Predictor as JaxPredictor
from sleap_nn_tpu.inference.providers import VideoProvider as JaxVideoProvider
from sleap_nn_tpu.inference.run import predict as jax_predict
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu_torch import cli as pcli
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.inference import predictor as ppred
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io.slp import load_slp
from sleap_nn_tpu_torch.parallel import get_mesh, replicate, shard_batch_spec
from sleap_nn_tpu_torch.training import ModelTrainer
from tests.test_torch_model_dir import (
    KW,
    FrameVideo,
    _assert_same,
    condition,
    config_dict,
    frames_and_labels,
)
from tests.test_torch_multiclass import _condition as condition_mc
from tests.test_torch_multiclass import _dir_config as mc_config
from tests.test_torch_multiclass import id_labels
from tests.test_torch_run_video import write_clip
from tests.test_torch_segmentation_dirs import assert_same_seg_labels, condition_seg, seg_config
from tests.test_torch_topdown import blob_frames
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

TWO_CPU = [torch.device("cpu"), torch.device("cpu")]
BATCH = 8  # divides the JAX package's 8 virtual devices and the port's 2 replicas
TYPE_SETS = {"single_instance": ("single_instance",),
             "topdown": ("centroid", "centered_instance"),
             "bottomup": ("bottomup",),
             "multi_class_bottomup": ("multi_class_bottomup",)}
ATOL = {"single_instance": 1e-4, "topdown": 1e-4, "bottomup": 1e-5,
        "multi_class_bottomup": 1e-5}


GROUPS = {"pose": ("single_instance", "centroid", "centered_instance", "bottomup"),
          "identity": ("multi_class_bottomup", "multi_class_topdown", "mc_centroid"),
          "segmentation": ("bottomup_segmentation", "semantic_segmentation",
                           "centered_instance_segmentation")}


def _train_dir(name, root):
    """The conditioned dir of ``name`` (``mc_centroid``: the centroid model of
    the identity frames), trained one step on the CPU."""
    group = next(g for g, names in GROUPS.items() if name in names)
    if group == "identity":
        mt = "centroid" if name == "mc_centroid" else name
        frames = blob_frames(8, seed=2)
        labels = id_labels(pio, frames=frames, max_inst=2, seed=2, spread=4)
        cfg = mc_config(mt, root / "mc")
    else:
        mt = name
        frames, labels = frames_and_labels(pio, 1 if mt == "single_instance" else 2)
        cfg = (config_dict if group == "pose" else seg_config)(
            mt, root if group == "pose" else root / "seg")
    trainer = ModelTrainer.get_model_trainer_from_config(PConfig.from_dict(cfg), [labels],
                                                         device="cpu")
    trainer.train()
    if group == "pose":
        condition(trainer.model, frames, mt)
    elif group == "identity":
        condition_mc(trainer.model, frames)
    else:
        crops = np.zeros((4, 32, 32, 1), np.uint8)
        crops[:, 4:28, 4:28] = frames[:4, 20:44, 20:44]
        condition_seg(trainer.model, crops if mt.startswith("centered") else frames)
    trainer.save_checkpoint("best.ckpt")
    return trainer.ckpt_dir


class _Dirs:
    """One conditioned dir per model type, each trained on first use, so a
    module trains only the types its tests read."""

    def __init__(self, root):
        self._root, self._built = root, {}

    def __getattr__(self, name):
        if name.startswith("_") or not any(name in g for g in GROUPS.values()):
            raise AttributeError(name)
        if name not in self._built:
            self._built[name] = _train_dir(name, self._root)
        return self._built[name]


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    return _Dirs(tmp_path_factory.mktemp("dp_runs"))


def _paths(dirs, type_set):
    return [str(getattr(dirs, mt)) for mt in TYPE_SETS[type_set]]


def _video(n=11, seed=9):
    return FrameVideo(blob_frames(n, seed=seed))


def _port(paths, video, data_parallel, **kw):
    return Predictor.from_model_paths(paths, batch_size=BATCH, device="cpu",
                                      data_parallel=data_parallel, **kw).predict(
        video, make_labels=False)


# -- the mesh ----------------------------------------------------------------------


def test_mesh_is_every_device_or_the_ones_given():
    assert get_mesh(device="cpu") == [torch.device("cpu")]
    assert get_mesh(devices=["cpu", "cpu"]) == TWO_CPU
    assert get_mesh(num_devices=1, devices=None, device="cpu") == [torch.device("cpu")]
    assert [s for s in shard_batch_spec(8, TWO_CPU)] == [slice(0, 4), slice(4, 8)]
    built = replicate(lambda d: ns(device=d), TWO_CPU)
    assert [b.device for b in built] == TWO_CPU and built[0] is not built[1]
    with pytest.raises(ValueError, match="no device"):
        get_mesh(devices=[])


# -- parity --------------------------------------------------------------------------


@pytest.mark.parametrize("type_set", TYPE_SETS)
def test_two_replicas_match_one_device_and_jax_data_parallel(dirs, type_set):
    """11 frames in batches of 8: the second batch is 3 frames and 5 pads."""
    video = _video()
    paths, kw = _paths(dirs, type_set), KW.get(type_set, {})
    got = _port(paths, video, TWO_CPU, **kw)
    plain = _port(paths, video, False, **kw)
    _assert_same(got, plain)
    assert [o["valid"].sum() for o in got] == [8, 3]
    jp = JaxPredictor.from_model_paths(paths, batch_size=BATCH, data_parallel=True, **kw)
    assert jp._mesh.devices.size == 8
    want = jp.predict(video, provider=JaxVideoProvider(video, batch_size=BATCH),
                      make_labels=False)
    _assert_same(got, want, atol=ATOL[type_set])


# The other type sets from_model_paths builds: the dirs, run.predict's knobs.
MORE_TYPE_SETS = {
    "centroid": (("centroid",), {}),
    "multi_class_topdown": (("mc_centroid", "multi_class_topdown"), {}),
    "semantic_segmentation": (("semantic_segmentation",), {"mask_output": "both"}),
    "topdown_segmentation": (("centroid", "centered_instance_segmentation"), {}),
}


@pytest.mark.parametrize("type_set", MORE_TYPE_SETS)
def test_the_other_type_sets_split_and_join_alike(dirs, type_set):
    """Two replicas give the port's one device exactly and the JAX
    package's data-parallel ``Labels`` with the dir tests' tolerances."""
    names, kw = MORE_TYPE_SETS[type_set]
    paths = [str(getattr(dirs, n)) for n in names]
    frames = blob_frames(11, seed=9)
    psrc = pio.Labels([pio.LabeledFrame(FrameVideo(frames), i) for i in range(11)])
    jsrc = jio.Labels([jio.LabeledFrame(FrameVideo(frames), i) for i in range(11)])
    got = prun.predict(psrc, paths, batch_size=BATCH, device="cpu", data_parallel=TWO_CPU,
                       **kw)
    plain = prun.predict(psrc, paths, batch_size=BATCH, device="cpu", **kw)
    want = jax_predict(jsrc, paths, batch_size=BATCH, data_parallel=True, **kw)
    if type_set.endswith("segmentation"):
        assert_same_seg_labels(got, plain, atol=0)
        assert_same_seg_labels(got, want)
        assert sum(len(lf.masks) for lf in got) >= 3
        return
    for g_labels, w_labels, atol in ((got, plain, 0.0), (got, want, 1e-4)):
        assert [lf.frame_idx for lf in g_labels] == [lf.frame_idx for lf in w_labels]
        for g, w in zip(g_labels, w_labels):
            assert len(g.instances) == len(w.instances)
            for gi, wi in zip(g.instances, w.instances):
                np.testing.assert_array_equal(np.isnan(gi.points), np.isnan(wi.points))
                np.testing.assert_allclose(gi.points, wi.points, rtol=0, atol=atol)
                assert getattr(gi.track, "name", None) == getattr(wi.track, "name", None)
    assert sum(len(lf.instances) for lf in got) >= 3


def test_each_replica_holds_its_own_models(dirs):
    p = Predictor.from_model_paths(_paths(dirs, "topdown"), batch_size=BATCH, device="cpu",
                                   data_parallel=TWO_CPU)
    assert p.mesh == TWO_CPU and len(p.replicas) == 2 and p.replicas[0] is p.layer
    a, b = p.replicas
    for stage in ("centroid_layer", "instance_layer"):
        ma, mb = getattr(a, stage).backend.model, getattr(b, stage).backend.model
        assert ma is not mb
        for (ka, va), (kb, vb) in zip(ma.state_dict().items(), mb.state_dict().items()):
            assert ka == kb and torch.equal(va, vb) and va.data_ptr() != vb.data_ptr()
    bu = Predictor.from_model_paths(_paths(dirs, "bottomup"), batch_size=BATCH,
                                    device="cpu", data_parallel=TWO_CPU, **KW["bottomup"])
    assert bu.replicas[0].paf_scorer is not bu.replicas[1].paf_scorer


def test_bottomup_segmentation_labels_match(dirs):
    frames = blob_frames(11, seed=9)
    psrc = pio.Labels([pio.LabeledFrame(FrameVideo(frames), i) for i in range(11)])
    jsrc = jio.Labels([jio.LabeledFrame(FrameVideo(frames), i) for i in range(11)])
    path = [str(dirs.bottomup_segmentation)]
    got = prun.predict(psrc, path, batch_size=BATCH, device="cpu", data_parallel=TWO_CPU,
                       mask_output="both")
    plain = prun.predict(psrc, path, batch_size=BATCH, device="cpu", mask_output="both")
    want = jax_predict(jsrc, path, batch_size=BATCH, data_parallel=True, mask_output="both")
    assert_same_seg_labels(got, plain, atol=0)
    # Masks bit for bit; the centre instances to 5e-4 px: on frames 8-10
    # the port's centres part from the JAX package's by up to 1.1e-4 px
    # inside the frame (f32 rounding, 3e-6 relative), whether either
    # package runs on one device or several.
    assert_same_seg_labels(got, want, atol=5e-4)
    assert sum(len(lf.masks) for lf in got) >= 3


def test_ground_truth_centroids_split_with_their_frames(dirs):
    """A lone centered-instance model on a labels source: each replica
    crops around the ground-truth centroids of its own rows."""
    frames, labels = frames_and_labels(pio, 2, n=11, seed=4)
    _, jlabels = frames_and_labels(jio, 2, n=11, seed=4)
    path = [str(dirs.centered_instance)]
    got = prun.predict(labels, path, batch_size=BATCH, device="cpu", data_parallel=TWO_CPU,
                       anchor_part="n0", make_labels=False)
    plain = prun.predict(labels, path, batch_size=BATCH, device="cpu", anchor_part="n0",
                         make_labels=False)
    want = jax_predict(jlabels, path, batch_size=BATCH, data_parallel=True, anchor_part="n0",
                       make_labels=False)
    _assert_same(got, plain)
    _assert_same(got, want, atol=1e-4)
    assert np.isfinite(np.concatenate([o["pred_keypoints"] for o in got])).any()


def test_labels_and_command_line_take_data_parallel(dirs, tmp_path, monkeypatch):
    """``run.predict(data_parallel=True)`` and ``--data-parallel`` run on the
    mesh of every device (one on the CPU; two here, the mesh patched) and
    give what the plain run gives, from a labels source and a video file."""
    frames = blob_frames(11, seed=9)
    src = pio.Labels([pio.LabeledFrame(FrameVideo(frames), i) for i in range(11)])
    paths = _paths(dirs, "topdown")
    clip = tmp_path / "clip.avi"
    write_clip(clip, frames)
    plain = [prun.predict(s, paths, batch_size=BATCH, device="cpu") for s in (src, str(clip))]
    monkeypatch.setattr(ppred, "get_mesh", lambda devices=None, device="cuda": TWO_CPU)
    got = prun.predict(src, paths, batch_size=BATCH, device="cpu", data_parallel=True)
    out = tmp_path / "out.slp"
    argv = ["predict", "-i", str(clip), "-o", str(out), "--device", "cpu",
            "--batch-size", str(BATCH), "--data-parallel"]
    for p in paths:
        argv += ["-m", p]
    assert pcli.main(argv) == 0
    for g_labels, w_labels in zip((got, load_slp(out)), plain):
        assert [lf.frame_idx for lf in g_labels] == [lf.frame_idx for lf in w_labels]
        for g, w in zip(g_labels, w_labels):
            assert len(g.instances) == len(w.instances)
            for gi, wi in zip(g.instances, w.instances):
                np.testing.assert_array_equal(gi.points, wi.points)
    assert sum(len(lf.instances) for lf in got) >= 3


# -- the replicas' split and join ---------------------------------------------------------


class _RowLayer:
    """A layer whose outputs hold its rows (per row, per crop: 3 a row), a
    0-d value, an array of the frames' size made on the host, and a
    string."""

    def __init__(self):
        self.device = torch.device("cpu")

    def predict_async(self, frames):
        rows = frames.reshape(len(frames), -1)[:, :1].float()
        return {"rows": rows, "crops": rows.repeat_interleave(3, dim=0),
                "scalar": torch.tensor(2.0), "hw": np.array(frames.shape[1:3], np.int32),
                "note": "same"}


@pytest.mark.parametrize("n_replicas", [1, 2, 4, 8])
def test_split_and_join_keep_row_order(n_replicas):
    """Each replica takes its contiguous rows; the join puts them back in
    order."""
    reps = ppred._Replicas([_RowLayer() for _ in range(n_replicas)],
                           [torch.device("cpu")] * n_replicas, None, None)
    frames = np.arange(BATCH, dtype=np.uint8).reshape(BATCH, 1, 1, 1)
    fetched = reps.enqueue(Predictor(_RowLayer(), "centroid", device="cpu"), [frames])
    assert len(fetched) == n_replicas
    assert [len(host["rows"]) for _, host, _ in fetched] == [BATCH // n_replicas] * n_replicas
    joined = reps.join(fetched)
    np.testing.assert_array_equal(joined["rows"][:, 0], np.arange(BATCH))
    np.testing.assert_array_equal(joined["crops"][:, 0], np.repeat(np.arange(BATCH), 3))
    np.testing.assert_array_equal(joined["hw"], [1, 1])
    assert joined["scalar"] == 2.0 and joined["note"] == "same"


@pytest.mark.parametrize("n_replicas,n_rows", [(2, 5), (4, 6)])
def test_split_of_a_batch_that_does_not_divide_raises(n_replicas, n_rows):
    """No provider gives such a batch (each pads its last one to the batch
    size, which divides); one given directly is refused, not padded."""
    reps = ppred._Replicas([_RowLayer() for _ in range(n_replicas)],
                           [torch.device("cpu")] * n_replicas, None, None)
    with pytest.raises(ValueError, match="divide"):
        reps.enqueue(Predictor(_RowLayer(), "centroid", device="cpu"),
                     [np.zeros((n_rows, 1, 1, 1), np.uint8)])


def test_plain_predictor_is_one_replica(dirs):
    p = Predictor.from_model_paths(_paths(dirs, "single_instance"), batch_size=BATCH,
                                   device="cpu")
    assert p.mesh == [torch.device("cpu")] and p.replicas == [p.layer]
    layer = _RowLayer()
    direct = Predictor(layer, "centroid", device="cpu")
    assert direct.mesh == [torch.device("cpu")] and direct.replicas == [layer]


# -- refusals --------------------------------------------------------------------------


@pytest.mark.parametrize("batch_size", [3, 5])
def test_batch_that_does_not_divide_raises_jax_error(dirs, batch_size):
    for make in (lambda: Predictor.from_model_paths(
                     _paths(dirs, "single_instance"), batch_size=batch_size, device="cpu",
                     data_parallel=TWO_CPU),
                 lambda: JaxPredictor.from_model_paths(
                     _paths(dirs, "single_instance"), batch_size=batch_size,
                     data_parallel=True)):
        with pytest.raises(ValueError, match="divisible by the device count"):
            make()


def test_spin_up_log_names_the_replicas(dirs, caplog):
    caplog.set_level("INFO", logger="sleap_nn_tpu_torch")
    Predictor.from_model_paths(_paths(dirs, "single_instance"), batch_size=BATCH,
                               device="cpu", data_parallel=TWO_CPU)
    Predictor.from_model_paths(_paths(dirs, "single_instance"), batch_size=BATCH,
                               device="cpu")
    lines = [r.message for r in caplog.records if r.message.startswith("Loaded inference")]
    assert "replicas=2" in lines[0] and "replicas=1" in lines[1]


def test_return_confmaps_reach_every_replica(dirs):
    video = _video(8)
    p = Predictor.from_model_paths(_paths(dirs, "single_instance"), batch_size=BATCH,
                                   device="cpu", data_parallel=TWO_CPU)
    got = p.predict(video, make_labels=False, return_confmaps=True)
    plain = Predictor.from_model_paths(_paths(dirs, "single_instance"), batch_size=BATCH,
                                       device="cpu").predict(video, make_labels=False,
                                                             return_confmaps=True)
    _assert_same(got, plain)
    assert got[0]["confmaps"].shape[0] == BATCH
    # The call's flag went to scoped copies: the predictor's layers keep theirs.
    assert not any(r.post.return_confmaps for r in p.replicas)

