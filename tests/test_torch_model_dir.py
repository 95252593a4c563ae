"""Port parity: the model directory (trainer YAML + checkpoint), ``load_model``,
``Predictor.from_model_paths`` and ``run.predict`` against the JAX package.

The port's trainer writes one dir per model type (UNet filters 8,
max_stride 8, 64x64 frames, 3-node chain, one train step on the CPU):
``initial_config.yaml``, ``training_config.yaml``, ``best.ckpt``,
``last.ckpt`` and ``training_log.csv``. Both packages read the YAML to the
same dict, and the port reads YAML the JAX package wrote to the same.

For prediction, a copy of each dir gets conditioned weights, written by
the trainer's own ``save_checkpoint``: every bias zeroed and the confmap
head scaled so the maps reach about 1 on the frames' bright blobs, as in
``tests/test_torch_topdown.py`` and ``test_torch_bottomup.py``. Frames are
black away from the blobs, so there every feature is exactly 0 in both
frameworks and no float-noise tie decides a peak. The port's dir-built
predictions equal the in-memory model's exactly (same weights, same CPU
code); against the JAX package's ``load_model`` +
``Predictor.from_model_paths`` on the same dirs they match with the
tolerances of those tests: validity and counts exact, NaN placed exactly,
keypoints and values to 1e-4 (top-down, single-instance) and 1e-5
(bottom-up, with the JAX package's scipy grouping). The port refuses a
JAX-trained orbax dir by name; ``tools/orbax_to_torch.py`` converts it
(through ``weights.flax_to_torch_state``) into a dir that the port loads
and that predicts what the JAX package predicts on the orbax dir.
"""

import copy
import importlib.util
import shutil
from pathlib import Path
from types import SimpleNamespace as ns

import jax
import numpy as np
import pytest
import torch

import sleap_nn_tpu.native
from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.inference.loaders import load_model as jax_load_model
from sleap_nn_tpu.inference.predictor import Predictor as JaxPredictor
from sleap_nn_tpu.inference.providers import VideoProvider as JaxVideoProvider
from sleap_nn_tpu.inference.run import predict as jax_predict
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.training import ModelTrainer as JTrainer
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.inference import layers as tl
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.inference.backends import TorchBackend
from sleap_nn_tpu_torch.inference.loaders import load_model
from sleap_nn_tpu_torch.inference.paf_grouping import PAFScorer
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.training import ModelTrainer
from tests.test_torch_pipeline import cfg_dict
from tests.test_torch_topdown import blob_frames

HW, N_FRAMES, CROP = 64, 7, 32
TYPES = ("single_instance", "centroid", "centered_instance", "bottomup")
TYPE_SETS = {"single_instance": ("single_instance",),
             "topdown": ("centroid", "centered_instance"),
             "bottomup": ("bottomup",)}
# Random PAF heads score lines low: keep enough matches that instances form.
KW = {"single_instance": {}, "topdown": {}, "bottomup": {"min_line_scores": -0.5}}
FILES = {"initial_config.yaml", "training_config.yaml", "best.ckpt", "last.ckpt",
         "training_log.csv"}


class FrameVideo:
    """In-memory video for both packages: ``video[i]``, ``get_frame``,
    ``len`` and ``shape``, and the media-file ``videos_json`` row the JAX
    trainer writes for its ``.slp`` splits."""

    def __init__(self, frames, filename="frames.mp4"):
        self.frames = frames
        self.shape = frames.shape
        self.filename = filename

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        return self.frames[idx]

    def get_frame(self, idx, fmt=None):
        return self.frames[idx]

    def to_backend_json(self):
        return {"backend": {"filename": self.filename, "grayscale": None, "bgr": True,
                            "dataset": "", "input_format": ""}}


def frames_and_labels(io, max_inst, n=N_FRAMES + 1, seed=2):
    """Blob frames and labels with 1..max_inst 3-node instances per frame."""
    frames = blob_frames(n, seed=seed)
    rng = np.random.default_rng(seed)
    video = FrameVideo(frames)
    skel = io.Skeleton(["n0", "n1", "n2"], edges=[(0, 1), (1, 2)])
    lfs = []
    for f in range(n):
        insts = []
        for _ in range(int(rng.integers(1, max_inst + 1))):
            pts = rng.uniform(12, HW - 12, 2) + rng.normal(0, 4, (3, 2))
            insts.append(io.Instance(pts, skel))
        lfs.append(io.LabeledFrame(video, f, insts))
    return frames, io.Labels(lfs)


def config_dict(model_type, root):
    d = cfg_dict(model_type=model_type, batch=2, max_epochs=1, train_steps_per_epoch=1,
                 save_ckpt=True, ckpt_dir=str(root), run_name=model_type,
                 model_ckpt={"save_last": True})
    if model_type == "centered_instance":
        d["data_config"]["preprocessing"] = {"crop_size": CROP}
    return d


def _no_filename(d):
    return {k: v for k, v in d.items() if k != "filename"}


def condition(model, frames, model_type):
    """Zero every bias; scale the confmap head so the maps reach about 1 on
    the blobs (bottom-up: each channel moved onto [0, 1])."""
    head = {"single_instance": "SingleInstanceConfmapsHead", "centroid": "CentroidConfmapsHead",
            "centered_instance": "CenteredInstanceConfmapsHead",
            "bottomup": "MultiInstanceConfmapsHead"}[model_type]
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
        model.eval()
        maps = model(torch.from_numpy(frames / np.float32(255.0)))[head].numpy()
        top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
        conv = next(layer[head][0] for layer in model.head_layers if head in layer)
        if model_type == "bottomup":
            conv.weight.div_(torch.from_numpy(top - bottom)[:, None, None, None])
            conv.bias.copy_(torch.from_numpy(-bottom / (top - bottom)))
        else:
            scale = np.where(top > 0, 1 / np.maximum(top, 1e-12),
                             1 / np.minimum(bottom, -1e-12)).astype(np.float32)
            conv.weight.mul_(torch.from_numpy(scale)[:, None, None, None])


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Per model type: the as-trained dir, a conditioned copy, the trainer
    (holding the conditioned model) and the config dict as given."""
    root = tmp_path_factory.mktemp("runs")
    out = {}
    for mt in TYPES:
        frames, labels = frames_and_labels(pio, 1 if mt == "single_instance" else 2)
        given = config_dict(mt, root)
        trainer = ModelTrainer.get_model_trainer_from_config(
            PConfig.from_dict(copy.deepcopy(given)), [labels], device="cpu")
        trainer.train()
        trained = trainer.ckpt_dir
        cond = root / "conditioned" / mt
        shutil.copytree(trained, cond)
        condition(trainer.model, frames, mt)
        trainer.ckpt_dir = cond
        trainer.save_checkpoint("best.ckpt")
        out[mt] = ns(trained=trained, cond=cond, trainer=trainer, given=given, frames=frames)
    return out


@pytest.fixture
def scipy_grouping(monkeypatch):
    monkeypatch.setattr(sleap_nn_tpu.native, "paf_group_sample_native", lambda *a, **k: None)


def _video():
    return FrameVideo(blob_frames(N_FRAMES, seed=9))


# -- the model directory ---------------------------------------------------------


@pytest.mark.parametrize("model_type", TYPES)
def test_trainer_writes_the_model_dir(dirs, model_type):
    assert {p.name for p in dirs[model_type].trained.iterdir()} == FILES


@pytest.mark.parametrize("model_type", TYPES)
def test_both_packages_read_the_port_yaml_alike(dirs, model_type):
    d = dirs[model_type]
    path = d.trained / "training_config.yaml"
    port, jax_cfg = PConfig.load_yaml(path), JConfig.load_yaml(path)
    assert port.to_dict() == jax_cfg.to_dict()
    assert _no_filename(port.to_dict()) == _no_filename(d.trainer.config.to_dict())
    # The filled-in config names the skeleton, the run and the crop.
    assert port.trainer_config.run_name == model_type
    assert [n["name"] for n in port.data_config.skeletons[0]["nodes"]] == ["n0", "n1", "n2"]
    if model_type == "centered_instance":
        assert port.data_config.preprocessing.crop_size == CROP
    initial = d.trained / "initial_config.yaml"
    given = PConfig.from_dict(copy.deepcopy(d.given)).to_dict()
    assert _no_filename(PConfig.load_yaml(initial).to_dict()) == _no_filename(given)
    assert PConfig.load_yaml(initial).to_dict() == JConfig.load_yaml(initial).to_dict()
    assert PConfig.load_yaml(initial).data_config.skeletons is None


@pytest.mark.parametrize("model_type", TYPES)
def test_port_reads_jax_written_yaml_alike(tmp_path, model_type):
    cfg = JConfig.from_dict(config_dict(model_type, tmp_path))
    cfg.data_config.skeletons = [{"nodes": [{"name": "a"}], "edges": [], "symmetries": [],
                                  "name": "s"}]
    cfg.trainer_config.optimizer.lr = 3e-5
    cfg.save_yaml(tmp_path / "c.yaml")
    assert PConfig.load_yaml(tmp_path / "c.yaml").to_dict() == \
        JConfig.load_yaml(tmp_path / "c.yaml").to_dict()


@pytest.mark.parametrize("model_type", TYPES)
def test_load_model_is_strict_and_bit_exact(dirs, model_type):
    d = dirs[model_type]
    loaded = load_model(d.trained)
    assert loaded.model_type == model_type and loaded.skeleton_nodes == ["n0", "n1", "n2"]
    assert loaded.skeleton_edges == [("n0", "n1"), ("n1", "n2")]
    best = ModelTrainer.load_checkpoint_params(d.trained / "best.ckpt")
    state = loaded.model.state_dict()
    assert set(state) == set(best)
    assert all(torch.equal(state[k], best[k]) for k in best)
    # An explicit .ckpt wins; without best.ckpt, last.ckpt loads.
    last = ModelTrainer.load_checkpoint_params(d.trained / "last.ckpt")
    moved = d.trained.parent / f"{model_type}-no-best"
    shutil.copytree(d.trained, moved)
    (moved / "best.ckpt").unlink()
    for path in (d.trained / "last.ckpt", moved):
        got = load_model(path).model.state_dict()
        assert all(torch.equal(got[k], last[k]) for k in last)
    # The JAX package's loader reads the port's torch checkpoint too.
    assert jax_load_model(d.trained).model_type == model_type


def test_load_model_refuses_what_is_not_ported(tmp_path):
    v1 = tmp_path / "v1"
    v1.mkdir()
    (v1 / "training_config.json").write_text("{}")
    (v1 / "best_model.h5").write_bytes(b"")
    with pytest.raises(NotImplementedError, match="item 9"):
        load_model(v1)
    for head, item in (({"semantic_segmentation": {}}, "item 10"),
                       ({"bottomup_segmentation": {}}, "item 10")):
        d = tmp_path / next(iter(head))
        d.mkdir()
        PConfig.from_dict({"model_config": {"backbone_config": {"unet": {}},
                                            "head_configs": head}}).save_yaml(
            d / "training_config.yaml")
        with pytest.raises(NotImplementedError, match=item):
            load_model(d)


# -- predictions from dirs ---------------------------------------------------------


def _in_memory_predictor(dirs, type_set):
    """The conditioned trainers' models, built into layers by hand."""
    pre = tl.PreprocessConfig(ensure_grayscale=True, max_height=HW, max_width=HW, max_stride=8)
    post = tl.PostprocessConfig(peak_threshold=0.2)
    backend = lambda mt: TorchBackend(dirs[mt].trainer.model, None, device="cpu")  # noqa: E731
    skel = pio.Skeleton(["n0", "n1", "n2"], edges=[("n0", "n1"), ("n1", "n2")])
    if type_set == "single_instance":
        layer = tl.SingleInstanceLayer(backend("single_instance"), pre, post, device="cpu")
    elif type_set == "topdown":
        post_c = tl.PostprocessConfig(peak_threshold=0.2, max_instances=20)
        layer = tl.TopDownLayer(
            tl.CentroidLayer(backend("centroid"), pre, post_c, device="cpu"),
            tl.CenteredInstanceLayer(backend("centered_instance"), pre, post, device="cpu"),
            max_instances=20, crop_size=CROP, device="cpu")
    else:
        scorer = PAFScorer(["n0", "n1", "n2"], [("n0", "n1"), ("n1", "n2")], pafs_stride=4,
                           **KW["bottomup"])
        layer = tl.BottomUpLayer(backend("bottomup"), pre, post, scorer, device="cpu")
    return Predictor(layer, type_set, skel, batch_size=4, device="cpu")


def _paths(dirs, type_set, which="cond"):
    return [getattr(dirs[mt], which) for mt in TYPE_SETS[type_set]]


def _assert_same(got, want, atol=None):
    """Batch outputs equal: exactly (``atol`` None) or to ``atol`` with
    validity, counts and NaN placement exact."""
    assert len(got) == len(want)
    for g_out, w_out in zip(got, want):
        assert set(g_out) == set(w_out)
        for key in w_out:
            gs, ws = ((g_out[key], w_out[key]) if isinstance(w_out[key], list)
                      else ([g_out[key]], [w_out[key]]))
            assert len(gs) == len(ws), key
            for g, w in zip(gs, ws):
                g, w = np.asarray(g), np.asarray(w)
                assert g.shape == w.shape, key
                if atol is None or w.dtype.kind in "biu":
                    np.testing.assert_array_equal(g, w, err_msg=key)
                else:
                    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=key)
                    np.testing.assert_allclose(g, w.astype(g.dtype), atol=atol, rtol=0,
                                               err_msg=key)


def _found(results, type_set):
    if type_set == "bottomup":
        return sum(len(k) for out in results for k, v in zip(out["pred_keypoints"],
                                                             out["valid"]) if v)
    kp = np.concatenate([out["pred_keypoints"][out["valid"]] for out in results])
    return int(np.isfinite(kp).all(axis=(-1, -2)).sum())


@pytest.mark.parametrize("type_set", TYPE_SETS)
def test_dir_predictions_equal_the_in_memory_model(dirs, type_set):
    video = _video()
    got = prun.predict(video, _paths(dirs, type_set), batch_size=4, device="cpu",
                       make_labels=False, **KW[type_set])
    want = _in_memory_predictor(dirs, type_set).predict(video, make_labels=False)
    _assert_same(got, want)
    assert len(got) == 2 and got[1]["valid"].tolist() == [True, True, True, False]
    assert _found(got, type_set) >= 3


@pytest.mark.parametrize("type_set", TYPE_SETS)
def test_dir_predictions_match_the_jax_package(dirs, type_set, scipy_grouping):
    video = _video()
    paths = _paths(dirs, type_set)
    got = prun.predict(video, paths, batch_size=4, device="cpu", make_labels=False,
                       **KW[type_set])
    jp = JaxPredictor.from_model_paths(paths, batch_size=4, **KW[type_set])
    want = jp.predict(video, provider=JaxVideoProvider(video, batch_size=4), make_labels=False)
    _assert_same(got, want, atol=1e-5 if type_set == "bottomup" else 1e-4)
    assert _found(want, type_set) >= 3


def _assert_same_labels(got, want, atol=1e-4):
    """Frames in order with the same video slot and frame index; instances
    with the same points (NaN placed exactly), point scores and score."""
    assert len(got.labeled_frames) == len(want.labeled_frames)
    gv = {id(v): i for i, v in enumerate(got.videos)}
    wv = {id(v): i for i, v in enumerate(want.videos)}
    for g, w in zip(got.labeled_frames, want.labeled_frames):
        assert g.frame_idx == w.frame_idx and gv[id(g.video)] == wv[id(w.video)]
        assert len(g.instances) == len(w.instances)
        for gi, wi in zip(g.instances, w.instances):
            assert type(gi).__name__ == type(wi).__name__
            np.testing.assert_array_equal(np.isnan(gi.points), np.isnan(wi.points))
            np.testing.assert_allclose(gi.points, wi.points, atol=atol, rtol=0)
            np.testing.assert_array_equal(gi.visible, wi.visible)
            np.testing.assert_allclose(gi.point_scores, wi.point_scores, atol=atol, rtol=0)
            np.testing.assert_allclose(gi.score, wi.score, atol=atol, rtol=0)
            assert gi.skeleton.node_names == wi.skeleton.node_names


@pytest.mark.parametrize("type_set", TYPE_SETS)
def test_run_predict_labels_match_the_jax_package(dirs, type_set, scipy_grouping, tmp_path):
    frames = blob_frames(N_FRAMES, seed=9)
    video_p, video_j = FrameVideo(frames), FrameVideo(frames)
    labels_p = pio.Labels([pio.LabeledFrame(video_p, i) for i in range(N_FRAMES)])
    labels_j = jio.Labels([jio.LabeledFrame(video_j, i) for i in range(N_FRAMES)])
    paths = _paths(dirs, type_set)
    got = prun.predict(labels_p, paths, batch_size=4, device="cpu", **KW[type_set])
    want = jax_predict(labels_j, paths, batch_size=4, **KW[type_set])
    _assert_same_labels(got, want, atol=1e-5 if type_set == "bottomup" else 1e-4)
    assert got.videos == [video_p] and sum(len(lf) for lf in got) >= 3
    # The run's provenance: the JAX package's keys, its versions under the port's names.
    rename = {"sleap_nn_tpu_version": "sleap_nn_tpu_torch_version",
              "jax_version": "torch_version"}
    assert set(got.provenance) - {"device"} == {rename.get(k, k) for k in want.provenance}
    assert got.provenance["device"] == "cpu"  # the JAX run was given no device
    assert got.provenance["model_type"] == want.provenance["model_type"]
    assert got.provenance["frame_selection"] == want.provenance["frame_selection"]
    # Predictor.predict(make_labels=True) holds exactly its raw outputs.
    pred = Predictor.from_model_paths(paths, batch_size=4, device="cpu", **KW[type_set])
    raw = pred.predict(labels_p, make_labels=False)
    again = pred.predict(labels_p)
    _assert_same_labels(again, got, atol=0)
    n_raw = _found(raw, type_set)
    assert sum(len(lf) for lf in again) == n_raw


def test_run_predict_writes_a_slp_the_jax_package_reads(dirs, tmp_path):
    pytest.importorskip("h5py")
    from sleap_nn_tpu.io.slp import load_slp as jax_load_slp

    frames = blob_frames(N_FRAMES, seed=9)
    labels = pio.Labels([pio.LabeledFrame(FrameVideo(frames), i) for i in range(N_FRAMES)])
    out = tmp_path / "pred.slp"
    got = prun.predict(labels, _paths(dirs, "topdown"), batch_size=4, device="cpu",
                       output_path=out, embed=True)
    back = jax_load_slp(out)
    assert [lf.frame_idx for lf in back] == [lf.frame_idx for lf in got]
    for g, w in zip(got, back):
        np.testing.assert_array_equal(w.image, frames[g.frame_idx])
        np.testing.assert_array_equal(np.stack([i.points for i in w.instances]),
                                      np.stack([i.points for i in g.instances]))
    assert back.provenance["model_type"] == "topdown"


def _orbax_to_torch():
    path = Path(__file__).resolve().parent.parent / "tools" / "orbax_to_torch.py"
    spec = importlib.util.spec_from_file_location("orbax_to_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_jax_trained_orbax_dir_loads_and_predicts_alike(tmp_path):
    pytest.importorskip("orbax.checkpoint")
    import jax.numpy as jnp

    frames, labels = frames_and_labels(jio, 1)
    jt = JTrainer.get_model_trainer_from_config(
        JConfig.from_dict(config_dict("single_instance", tmp_path)), [labels])
    jt.train()
    # Condition the flax params: biases zeroed, each confmap channel moved
    # onto [0, 1] (so integral refinement divides by a patch mass well away
    # from 0), saved through the JAX trainer's own (orbax) checkpoint writer.
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.zeros_like(v) if path[-1].key == "bias" else np.asarray(v),
        jax.device_get(jt.params))
    head = params["params"]["SingleInstanceConfmapsHead"]["head_conv"]
    maps = np.asarray(jt.model.apply(params, jnp.asarray(frames / 255.0, jnp.float32))[
        "SingleInstanceConfmapsHead"])
    top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
    head["kernel"] = (head["kernel"] / (top - bottom)).astype(np.float32)
    head["bias"] = (-bottom / (top - bottom)).astype(np.float32)
    jt.params = params
    jt.save_checkpoint("best.ckpt")
    run = jt.ckpt_dir
    assert (run / "best.ckpt").is_dir()

    with pytest.raises(ValueError, match="tools/orbax_to_torch.py"):
        load_model(run)

    converted = _orbax_to_torch().convert(run, tmp_path / "converted")
    assert {p.name for p in converted.iterdir()} >= {"training_config.yaml", "best.ckpt"}
    loaded = load_model(converted)
    want_state = ModelTrainer.load_checkpoint_params(converted / "best.ckpt")
    assert set(loaded.model.state_dict()) == set(want_state)
    assert all(torch.equal(loaded.model.state_dict()[k], v) for k, v in want_state.items())
    # The JAX package's torch-checkpoint importer reads the converted file
    # back to the orbax dir's flax params.
    back = jax.tree_util.tree_leaves_with_path(jax_load_model(converted).params)
    orig = dict(jax.tree_util.tree_leaves_with_path(params))
    assert len(back) == len(orig)
    for path, leaf in back:
        np.testing.assert_array_equal(np.asarray(leaf), orig[path])
    video = _video()
    got = prun.predict(video, [converted], batch_size=4, device="cpu", make_labels=False)
    want = JaxPredictor.from_model_paths([run], batch_size=4).predict(
        video, provider=JaxVideoProvider(video, batch_size=4), make_labels=False)
    _assert_same(got, want, atol=1e-4)
    assert _found(want, "single_instance") >= 3


# -- what is not ported raises ---------------------------------------------------------


@pytest.mark.parametrize("knob,value,match", [
    ("host_resize", True, "item 3"),
    ("data_parallel", True, "item 13"),
    ("packed_level0", True, "TPU layout"),
    ("centroid_only", True, "item 2"),
    ("anchor_part", "n0", "item 10"),
    ("backbone_ckpt_path", "x.ckpt", "item 2"),
    ("head_ckpt_path", "x.ckpt", "item 2"),
    ("merge_fragments", True, "item 10"),
    ("fg_threshold", 0.7, "item 10"),
    ("mask_output", "polygon", "item 10"),
])
def test_from_model_paths_refuses_unported_knobs(dirs, knob, value, match):
    with pytest.raises(NotImplementedError, match=match):
        Predictor.from_model_paths(_paths(dirs, "single_instance"), device="cpu",
                                   **{knob: value})
    # The knob at its no-op value is accepted.
    default = {"host_resize": False, "data_parallel": False, "packed_level0": None,
               "centroid_only": False, "anchor_part": None, "backbone_ckpt_path": None,
               "head_ckpt_path": None, "merge_fragments": False, "fg_threshold": 0.5,
               "mask_output": "mask"}[knob]
    Predictor.from_model_paths(_paths(dirs, "single_instance"), device="cpu",
                               **{knob: default})


@pytest.mark.parametrize("types,error,match", [
    (("centroid",), NotImplementedError, "item 2"),
    (("centered_instance",), NotImplementedError, "item 10"),
    (("single_instance", "single_instance"), ValueError, "Duplicate model type"),
    (("single_instance", "bottomup"), ValueError, "Unsupported model type combination"),
])
def test_from_model_paths_refuses_unported_type_sets(dirs, types, error, match):
    with pytest.raises(error, match=match):
        Predictor.from_model_paths([dirs[t].cond for t in types], device="cpu")


@pytest.mark.parametrize("kwargs,match", [
    ({"tracking": True, "features": "masks"}, "item 10"),
    ({"tracking": True, "scoring_method": "mask_iou"}, "item 10"),
    ({"output_format": "analysis_h5"}, "item 13"),
    ({"mask_backend": "sam"}, "item 13"),
    ({"runtime": "onnx"}, "item 13"),
    ({"profile_dir": "prof"}, "item 13"),
    ({"centroid_output": "centroid"}, "item 2"),
    ({"host_resize": True}, "item 3"),
    ({"data_path": "clip.mp4"}, "item 3"),
    ({"data_path": "https://example.com/a.slp"}, "fetch_remote_data"),
    ({"video_path_map": "a=b"}, "item 13"),
    ({"video_index": 0}, "item 13"),
    ({"exclude_user_labeled": True}, "item 13"),
    ({"only_labeled_frames": True}, "item 13"),
    ({"only_predicted_frames": True}, "item 13"),
    ({"no_empty_frames": True}, "item 13"),
    ({"queue_maxsize": 8}, "item 13"),
    ({"restore_source_videos": True}, "item 13"),
    ({"video_dataset": "frames"}, "item 13"),
    ({"video_input_format": "channels_first"}, "item 13"),
])
def test_run_predict_refuses_unported_features(dirs, kwargs, match):
    kwargs = {"data_path": _video(), **kwargs}
    with pytest.raises(NotImplementedError, match=match):
        prun.predict(model_paths=_paths(dirs, "single_instance"), device="cpu", **kwargs)


def test_dir_predictor_runs_on_the_card_unless_asked(dirs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Predictor.from_model_paths(_paths(dirs, "single_instance"))
    with pytest.raises(RuntimeError, match="CUDA"):
        prun.predict(_video(), _paths(dirs, "single_instance"))


def test_run_predict_streams_to_file_and_scopes_labels(dirs, tmp_path):
    pytest.importorskip("h5py")
    from sleap_nn_tpu_torch.io.slp import load_slp

    frames = blob_frames(N_FRAMES, seed=9)
    video = FrameVideo(frames)
    skel = pio.Skeleton(["n0", "n1", "n2"])
    labels = pio.Labels([pio.LabeledFrame(video, i, [pio.Instance(np.ones((3, 2)), skel)]
                                          if i % 2 else []) for i in range(N_FRAMES)],
                        suggestions=[pio.SuggestionFrame(video, 5)])
    paths = _paths(dirs, "single_instance")
    seen = []
    streamed = prun.predict(labels, paths, batch_size=4, device="cpu",
                            stream_to_file=tmp_path / "s.slp", write_interval=2,
                            progress_callback=seen.append)
    back = load_slp(tmp_path / "s.slp")
    assert [lf.frame_idx for lf in back] == [lf.frame_idx for lf in streamed]
    assert seen[-1] == N_FRAMES and back.provenance["model_type"] == "single_instance"
    # The JAX predict's other scoping options are refused, never ignored.
    with pytest.raises(NotImplementedError, match="only_labeled_frames"):
        prun.predict(labels, paths, batch_size=4, device="cpu", only_labeled_frames=True)
    # At their no-op values they are accepted.
    quiet = prun.predict(labels, paths, batch_size=4, device="cpu",
                         **{k: v for k, (v, _) in prun.UNPORTED_RUN_KNOBS.items()})
    assert [lf.frame_idx for lf in quiet] == [lf.frame_idx for lf in streamed]
    suggested = prun.predict(labels, paths, batch_size=4, device="cpu",
                             only_suggested_frames=True)
    assert [lf.frame_idx for lf in suggested] == [5]
    assert suggested.provenance["frame_selection"]["method"] == "suggested"
    with pytest.raises(ValueError, match="frames selects frames of a video"):
        Predictor.from_model_paths(paths, device="cpu").predict(labels, frames=[0])
