"""Port parity: SLEAP v1 model dirs (``training_config.json`` + Keras
``best_model.h5``) against the JAX package's importer.

The test writes the v1 dirs itself. Weights: a port UNet of the mapped
config, drawn from a numpy seed, biases zeroed and the confmap head scaled
so the maps reach about 1 on the frames' blobs (as in
``tests/test_torch_model_dir.py``), then exported under the Keras layer
names in Keras's layout (HWIO kernels; a ``Conv2DTranspose`` kernel as
``(h, w, OUT, IN)``). The ``.h5`` files are written with h5py in the
layout Keras gives them (``model_weights/<layer>/<layer>/kernel:0``, the
``layer_names`` / ``weight_names`` byte-string array attributes,
``backend``, ``keras_version`` and a root ``model_config``) and once more
with the port's own ``io/hdf5.py`` writer. A layer the importer does not
map (``OffsetRefinementHead_0``) and one of a wrong shape land in the
skipped list of both packages alike.

Checks: the Keras weights, the mapped and skipped lists and the config
mapping equal the JAX package's; the imported model's outputs equal the
JAX model's (1e-4 relative, with the "tf" transposed-conv phase under
``up_interpolate: false``); a v1 top-down pair predicts through
``load_model`` -> ``run.predict`` what the JAX package's ``predict`` does
(instance counts exactly, points within 1e-3 px, scores within 1e-4); the
command line's ``predict -m`` of the pair equals ``run.predict`` and its
``info`` reads a v1 dir; the refusals raise as the JAX package's do.
"""

import json

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu import legacy_models as jlegacy
from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.inference.loaders import load_model as jax_load_model
from sleap_nn_tpu.inference.run import predict as jax_predict
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu_torch import legacy_models as plegacy
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.inference.loaders import load_model
from sleap_nn_tpu_torch.io import hdf5
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.weights import flax_to_torch_state, torch_key_paths
from tests.test_torch_model_dir import FrameVideo, condition
from tests.test_torch_topdown import blob_frames

HW, N_FRAMES, CROP = 64, 6, 32
PARTS = ["n0", "n1", "n2"]


def _node(name):
    return {"py/object": "sleap.skeleton.Node", "py/state": {"py/tuple": [name, 1.0]}}


def v1_skeleton():
    """A jsonpickle skeleton as SLEAP v1 writes it: the first mention of a
    node is its object, later ones ``py/id`` back-references."""
    return {
        "directed": True, "graph": {"name": "Skeleton-v1", "num_edges_inserted": 2},
        "links": [
            {"key": 0, "source": _node("n0"), "target": _node("n1")},
            {"key": 0, "source": {"py/id": 2}, "target": _node("n2")},
        ],
        "multigraph": True,
        "nodes": [{"id": {"py/id": 1}}, {"id": {"py/id": 2}}, {"id": {"py/id": 3}}],
    }


def v1_config(head: str, up_interpolate: bool = True) -> dict:
    heads = {
        "centroid": {"centroid": {"anchor_part": None, "sigma": 5.0, "output_stride": 2}},
        "centered_instance": {"centered_instance": {
            "part_names": PARTS, "anchor_part": None, "sigma": 2.5, "output_stride": 2}},
        "single_instance": {"single_instance": {
            "part_names": PARTS, "sigma": 2.5, "output_stride": 2}},
    }[head]
    return {
        "data": {
            "labels": {"training_labels": "train.slp", "validation_labels": "val.slp",
                       "validation_fraction": 0.2, "skeletons": [v1_skeleton()]},
            "preprocessing": {"ensure_rgb": False, "ensure_grayscale": True,
                              "input_scaling": 1.0},
            "instance_cropping": {"crop_size": CROP if head == "centered_instance" else None},
        },
        "model": {
            "backbone": {"unet": {"filters": 8, "filters_rate": 1.5, "max_stride": 8,
                                  "output_stride": 2, "stem_stride": None,
                                  "middle_block": True, "up_interpolate": up_interpolate,
                                  "stacks": 1}},
            "heads": heads,
        },
        "optimization": {
            "batch_size": 2, "epochs": 7, "optimizer": "adam", "initial_learning_rate": 5e-4,
            "learning_rate_schedule": {"reduce_on_plateau": True, "reduction_factor": 0.3,
                                       "plateau_min_delta": 1e-5, "plateau_patience": 4,
                                       "plateau_cooldown": 2, "min_learning_rate": 1e-7},
            "early_stopping": {"stop_training_on_plateau": True, "plateau_patience": 6},
            "hard_keypoint_mining": {"online_mining": True},
        },
        "outputs": {"run_name": head, "run_name_prefix": "v1_", "run_name_suffix": ".n3"},
    }


def keras_weights(model) -> dict:
    """The port model's weights under their Keras layer names, in Keras's
    layout: ``{layer: {"kernel": ..., "bias": ...}}``."""
    out = {}
    state = model.state_dict()
    for key, (path, kind) in torch_key_paths(model).items():
        parts = key.split(".")
        layer = parts[-2] if parts[0] == "backbone" else f"{parts[2]}_0"
        value = state[key].numpy()
        if kind == "conv_kernel":
            value = value.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        elif kind == "trans_conv_kernel":
            value = np.swapaxes(value.transpose(2, 3, 0, 1)[::-1, ::-1], -1, -2)
        out.setdefault(layer, {})[path[-1]] = np.ascontiguousarray(value, np.float32)
    return out


def write_keras_h5(path, weights, writer="h5py"):
    """A Keras ``best_model.h5``: h5py's default layout, or the port's
    writer; ``backend``, ``keras_version`` and ``model_config`` besides."""
    opener = h5py.File if writer == "h5py" else hdf5.File
    names = sorted(weights)
    with opener(path, "w") as f:
        f.attrs["backend"] = "tensorflow"
        f.attrs["keras_version"] = "2.3.1"
        f.attrs["model_config"] = json.dumps({"class_name": "Model",
                                              "config": {"layers": names}})
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array([n.encode() for n in names + ["input_1"]])
        mw.attrs["backend"] = b"tensorflow"
        mw.attrs["keras_version"] = b"2.3.1"
        mw.create_group("input_1").attrs["weight_names"] = np.array([], dtype="S1")
        for name in names:
            g = mw.create_group(name)
            kinds = sorted(weights[name])
            g.attrs["weight_names"] = np.array([f"{name}/{k}:0".encode() for k in kinds])
            inner = g.create_group(name)
            for k in kinds:
                inner.create_dataset(f"{k}:0", data=weights[name][k])


def build_v1_dir(root, head, frames, seed, up_interpolate=True, writer="h5py"):
    """A v1 model dir of ``head`` with conditioned weights; returns it."""
    legacy = v1_config(head, up_interpolate)
    cfg = plegacy.legacy_config_mapper(legacy)
    cfg.model_config.backbone_config.unet.in_channels = 1
    from sleap_nn_tpu_torch.config import get_backbone_config, get_head_config
    from sleap_nn_tpu_torch.models.model import Model

    model = Model.from_config("unet", get_backbone_config(cfg), get_head_config(cfg), head)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            fan_in = p[0].numel() if p.ndim > 1 else 1
            p.copy_(torch.from_numpy(
                (rng.standard_normal(p.shape) * np.sqrt(2.0 / fan_in)).astype(np.float32)))
    condition(model, frames, head)
    weights = keras_weights(model)
    weights["OffsetRefinementHead_0"] = {"kernel": np.zeros((1, 1, 8, 6), np.float32),
                                         "bias": np.zeros(6, np.float32)}
    d = root / f"{head}{'' if up_interpolate else '_tconv'}_{writer}"
    d.mkdir(parents=True)
    (d / "training_config.json").write_text(json.dumps(legacy))
    write_keras_h5(d / "best_model.h5", weights, writer)
    return d


@pytest.fixture(scope="module")
def frames():
    return blob_frames(N_FRAMES + 2, seed=3)


@pytest.fixture(scope="module")
def v1_dirs(tmp_path_factory, frames):
    root = tmp_path_factory.mktemp("v1")
    return {
        "centroid": build_v1_dir(root, "centroid", frames, 0),
        "centered_instance": build_v1_dir(root, "centered_instance", frames, 1,
                                          up_interpolate=False),
        "single_instance": build_v1_dir(root, "single_instance", frames, 2,
                                        up_interpolate=False, writer="port"),
        "centered_instance_bilinear": build_v1_dir(root, "centered_instance", frames, 3,
                                                   writer="port"),
    }


@pytest.mark.parametrize("which", ["centroid", "centered_instance", "single_instance",
                                   "centered_instance_bilinear"])
def test_keras_weights_and_import_lists_equal_jax(v1_dirs, which):
    d = v1_dirs[which]
    got, want = plegacy.load_keras_weights(d / "best_model.h5"), jlegacy.load_keras_weights(
        d / "best_model.h5")
    assert list(got) == list(want)
    for layer in want:
        assert list(got[layer]) == list(want[layer])
        for kind in want[layer]:
            np.testing.assert_array_equal(got[layer][kind], want[layer][kind])
    model, state, cfg, lists = plegacy.load_legacy_model(d)
    jmodel, jparams, jcfg, jlists = jlegacy.load_legacy_model(d)
    assert lists == jlists
    assert lists["skipped"] == ["OffsetRefinementHead_0"]
    assert cfg.to_dict() == jcfg.to_dict()
    # Every leaf came from the file: the JAX params, converted, are the port's.
    want_state = flax_to_torch_state(jparams, model)
    assert set(want_state) == set(state)
    for k in state:
        torch.testing.assert_close(state[k], want_state[k], rtol=0, atol=0)
    x = np.random.default_rng(4).random((2, HW, HW, 1), dtype=np.float32)
    want_out = jmodel.apply(jparams, jnp.asarray(x))
    with torch.no_grad():
        got_out = model(torch.from_numpy(x))
    for k in want_out:
        w = np.asarray(want_out[k])
        assert float(np.abs(got_out[k].numpy() - w).max()) <= 1e-4 * float(np.abs(w).max())


def test_h5py_and_port_writers_give_the_same_import(tmp_path, frames):
    a = build_v1_dir(tmp_path, "centroid", frames, 5, writer="h5py")
    b = build_v1_dir(tmp_path, "centroid", frames, 5, writer="port")
    wa, wb = plegacy.load_keras_weights(a / "best_model.h5"), plegacy.load_keras_weights(
        b / "best_model.h5")
    assert list(wa) == list(wb)
    for layer in wa:
        for kind in wa[layer]:
            np.testing.assert_array_equal(wa[layer][kind], wb[layer][kind])
    # The port's reader reads the Keras attributes it is asked for.
    for d in (a, b):
        with hdf5.File(d / "best_model.h5", "r") as f:
            names = [n.decode() for n in f["model_weights"].attrs["layer_names"]]
            assert names[-1] == "input_1" and "CentroidConfmapsHead_0" in names
            assert json.loads(f.attrs["model_config"])["class_name"] == "Model"


def test_skipped_shape_mismatch_as_jax(tmp_path, frames):
    d = build_v1_dir(tmp_path, "centroid", frames, 6)
    weights = plegacy.load_keras_weights(d / "best_model.h5")
    weights["CentroidConfmapsHead_0"]["kernel"] = np.zeros((1, 1, 5, 1), np.float32)
    write_keras_h5(d / "best_model.h5", weights)
    _, _, _, lists = plegacy.load_legacy_model(d)
    _, _, _, jlists = jlegacy.load_legacy_model(d)
    assert lists == jlists
    assert any(s.startswith("CentroidConfmapsHead_0/kernel (shape") for s in lists["skipped"])


def test_config_mapping_equals_jax(v1_dirs, tmp_path):
    for head in ("centroid", "centered_instance", "single_instance"):
        legacy = v1_config(head)
        got, want = plegacy.legacy_config_mapper(legacy), jlegacy.legacy_config_mapper(legacy)
        assert got.to_dict() == want.to_dict()
        assert got.trainer_config.run_name == f"v1_{head}.n3"
        assert [n["name"] for n in got.data_config.skeletons[0]["nodes"]] == PARTS
        assert [(e["source"]["name"], e["destination"]["name"])
                for e in got.data_config.skeletons[0]["edges"]] == [("n0", "n1"), ("n1", "n2")]
    # ``TrainingJobConfig.load_yaml`` of a v1 JSON maps it (``train legacy.json``).
    path = v1_dirs["centroid"] / "training_config.json"
    got, want = PConfig.load_yaml(path), JConfig.load_yaml(path)
    assert got.to_dict() == want.to_dict()
    assert got.model_config.backbone_config.unet.trans_conv_phase == "tf"
    # A v1 mapping with no run name has none, as in JAX.
    bare = {"model": {}, "outputs": {}}
    assert plegacy.legacy_config_mapper(bare).to_dict() == \
        jlegacy.legacy_config_mapper(bare).to_dict()


def test_v1_topdown_pair_predicts_as_jax(v1_dirs):
    frames = blob_frames(N_FRAMES, seed=9)
    video_p, video_j = FrameVideo(frames), FrameVideo(frames)
    labels_p = pio.Labels([pio.LabeledFrame(video_p, i) for i in range(N_FRAMES)])
    labels_j = jio.Labels([jio.LabeledFrame(video_j, i) for i in range(N_FRAMES)])
    paths = [v1_dirs["centroid"], v1_dirs["centered_instance"]]
    loaded = load_model(paths[1])
    assert loaded.model_type == "centered_instance"
    assert loaded.skeleton_nodes == PARTS
    assert loaded.config.model_config.backbone_config.unet.up_interpolate is False
    jl = jax_load_model(paths[1])
    assert loaded.skeleton_edges == [tuple(e) for e in jl.skeleton_edges]
    got = prun.predict(labels_p, paths, batch_size=4, device="cpu")
    want = jax_predict(labels_j, paths, batch_size=4)
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    n = 0
    for g, w in zip(got, want):
        assert len(g.instances) == len(w.instances)
        for gi, wi in zip(g.instances, w.instances):
            np.testing.assert_array_equal(np.isnan(gi.points), np.isnan(wi.points))
            np.testing.assert_allclose(gi.points, wi.points, atol=1e-3, rtol=0)
            np.testing.assert_allclose(gi.point_scores, wi.point_scores, atol=1e-4, rtol=0)
            np.testing.assert_allclose(gi.score, wi.score, atol=1e-4, rtol=0)
            n += 1
    assert n >= 3


def test_refusals_raise_as_jax(tmp_path, v1_dirs):
    missing_json = tmp_path / "no_json"
    missing_json.mkdir()
    (missing_json / "best_model.h5").write_bytes(
        (v1_dirs["centroid"] / "best_model.h5").read_bytes())
    for fn in (plegacy.load_legacy_model, jlegacy.load_legacy_model):
        with pytest.raises(FileNotFoundError, match="training_config.json"):
            fn(missing_json)
    for loader in (load_model, jax_load_model):
        with pytest.raises(FileNotFoundError):
            loader(missing_json)
    no_h5 = tmp_path / "no_h5"
    no_h5.mkdir()
    (no_h5 / "training_config.json").write_text(json.dumps(v1_config("centroid")))
    for fn in (plegacy.load_legacy_model, jlegacy.load_legacy_model):
        with pytest.raises(FileNotFoundError, match="best_model.h5"):
            fn(no_h5)
    not_keras = tmp_path / "not_keras"
    not_keras.mkdir()
    (not_keras / "training_config.json").write_text(json.dumps(v1_config("centroid")))
    with h5py.File(not_keras / "best_model.h5", "w") as f:
        f.create_dataset("weights", data=np.zeros(3))
    for fn in (plegacy.load_legacy_model, jlegacy.load_legacy_model):
        with pytest.raises(ValueError, match="no 'model_weights' group"):
            fn(not_keras)


def test_command_line_on_v1_dirs(v1_dirs, tmp_path, capsys):
    """``predict -m`` of the v1 top-down pair equals ``run.predict``; ``info``
    reports a v1 dir through the v1 mapper."""
    import cv2

    from sleap_nn_tpu_torch import cli as pcli
    from sleap_nn_tpu_torch.io.slp import load_slp
    from sleap_nn_tpu_torch.model_info import get_model_info

    frames = blob_frames(N_FRAMES, seed=10)
    clip = tmp_path / "clip.avi"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"MJPG"), 10, (HW, HW))
    for f in frames:
        writer.write(np.repeat(f, 3, axis=-1))
    writer.release()
    paths = [str(v1_dirs["centroid"]), str(v1_dirs["centered_instance"])]
    out = tmp_path / "out.slp"
    assert pcli.main(["predict", "-i", str(clip), "-m", paths[0], "-m", paths[1], "-o",
                      str(out), "--device", "cpu"]) == 0
    want = prun.predict(str(clip), paths, device="cpu")
    got = load_slp(out)
    assert [len(lf) for lf in got] == [len(lf) for lf in want]
    for g, w in zip(got, want):
        for gi, wi in zip(g.instances, w.instances):
            np.testing.assert_allclose(gi.points, wi.points, atol=1e-4, rtol=0)
    info = get_model_info(v1_dirs["centered_instance"])
    weights = plegacy.load_keras_weights(v1_dirs["centered_instance"] / "best_model.h5")
    assert info["model_type"] == "centered_instance" and info["backbone"] == "unet"
    assert info["skeleton_nodes"] == PARTS
    assert info["total_params"] == sum(v.size for w in weights.values() for v in w.values())
    capsys.readouterr()
    assert pcli.main(["info", paths[1]]) == 0
    assert "UNet (8 filters" in capsys.readouterr().out
