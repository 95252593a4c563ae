"""Port parity: model dirs of the ConvNeXt, SwinT and pretrained backbones,
predicted through ``load_model`` -> ``run.predict`` (and the command line's
``predict -m``) against the JAX package's ``predict`` on the same config and
params.

Each case draws a flax model's params from a numpy seed, conditions them
(every bias zeroed, the confmap head scaled so the maps reach about 1 on
the frames' blobs; bottom-up: each channel moved onto [0, 1] and the PAF
head scaled to fields of about 1), and writes
two dirs with one ``training_config.yaml``: the port's (``best.ckpt`` of
the params converted by ``weights.flax_to_torch_state``) and the JAX
trainer's (an orbax ``best.ckpt``). Paths: top-down with ConvNeXt for both
stages, bottom-up with SwinT, single-instance with a ConvNeXtV2 pretrained
encoder (from a ``config.json`` snapshot). Instance counts must be equal,
points within 1e-3 px and scores within 1e-4; a ConvNeXt model on the
port's default backend keeps its decoder off the fused kernel.
"""

import json

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sleap_nn_tpu.config import TrainingJobConfig as JConfig
from sleap_nn_tpu.config import get_backbone_config as j_backbone_config
from sleap_nn_tpu.config import get_head_config as j_head_config
from sleap_nn_tpu.inference.run import predict as jax_predict
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.models.model import Model as FlaxModel
from sleap_nn_tpu_torch import cli as pcli
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.inference.backends import TorchBackend, maybe_fuse_convs
from sleap_nn_tpu_torch.inference.loaders import load_model
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io.slp import load_slp
from sleap_nn_tpu_torch.weights import flax_to_torch_state
from tests.test_torch_backbones import random_params
from tests.test_torch_model_dir import FrameVideo
from tests.test_torch_pretrained import CONFIGS as PRETRAINED_CONFIGS
from tests.test_torch_topdown import blob_frames

HW, N_FRAMES, CROP = 64, 6, 32
PARTS = ["n0", "n1", "n2"]
EDGES = [["n0", "n1"], ["n1", "n2"]]
HEAD = {"single_instance": "SingleInstanceConfmapsHead", "centroid": "CentroidConfmapsHead",
        "centered_instance": "CenteredInstanceConfmapsHead",
        "bottomup": "MultiInstanceConfmapsHead"}
CONVNEXT = {"convnext": {"arch": {"depths": [1, 1, 1, 1], "channels": [8, 16, 32, 64]},
                         "output_stride": 2, "max_stride": 32}}
SWINT = {"swint": {"arch": {"embed": 8, "depths": [1, 2, 1, 1], "num_heads": [2, 2, 2, 2]},
                   "window_size": 4, "output_stride": 2, "max_stride": 32}}


def heads_for(model_type):
    if model_type == "centroid":
        return {"confmaps": {"anchor_part": None, "sigma": 3.0, "output_stride": 2}}
    if model_type == "bottomup":
        return {"confmaps": {"part_names": PARTS, "sigma": 2.5, "output_stride": 2},
                "pafs": {"edges": EDGES, "sigma": 15.0, "output_stride": 4}}
    return {"confmaps": {"part_names": PARTS, "sigma": 2.5, "output_stride": 2}}


def dir_config(backbone: dict, model_type: str) -> dict:
    return {
        "data_config": {
            "preprocessing": {"crop_size": CROP if model_type == "centered_instance" else None},
            "skeletons": [{"name": "s", "nodes": [{"name": n} for n in PARTS],
                           "edges": [{"source": {"name": s}, "destination": {"name": d}}
                                     for s, d in EDGES], "symmetries": []}],
        },
        "model_config": {"backbone_config": backbone,
                         "head_configs": {model_type: heads_for(model_type)}},
        "trainer_config": {"run_name": model_type},
    }


def conditioned_params(fm, frames, model_type, seed):
    """Random flax variables with every bias zeroed and the confmap head
    scaled onto the blobs."""
    params = random_params(fm, jnp.zeros((1, HW, HW, 1)), seed=seed)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: np.zeros_like(v) if path[-1].key == "bias" else v, params)
    head = params["params"][HEAD[model_type]]["head_conv"]
    maps = np.asarray(jax.jit(fm.apply)(params, jnp.asarray(frames / 255.0, jnp.float32))[
        HEAD[model_type]])
    top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
    if model_type == "bottomup":
        head["kernel"] = (head["kernel"] / (top - bottom)).astype(np.float32)
        head["bias"] = (-bottom / (top - bottom)).astype(np.float32)
        pafs = params["params"]["PartAffinityFieldsHead"]["head_conv"]
        big = np.abs(np.asarray(jax.jit(fm.apply)(params, jnp.asarray(
            frames / 255.0, jnp.float32))["PartAffinityFieldsHead"])).max()
        pafs["kernel"] = (pafs["kernel"] / big).astype(np.float32)  # fields of about 1
    else:
        scale = np.where(top > 0, 1 / np.maximum(top, 1e-12), 1 / np.minimum(bottom, -1e-12))
        head["kernel"] = (head["kernel"] * scale).astype(np.float32)
    return params


def write_dirs(root, name, config: dict, params):
    """The port's dir and the JAX trainer's dir of one config and params."""
    import orbax.checkpoint as ocp

    pdir, jdir = root / "port" / name, root / "jax" / name
    for d in (pdir, jdir):
        d.mkdir(parents=True)
        PConfig.from_dict(json.loads(json.dumps(config))).save_yaml(d / "training_config.yaml")
    ocp.PyTreeCheckpointer().save((jdir / "best.ckpt").absolute(), {
        "params": params, "epoch": 0, "best_val_loss": 0.0})
    from sleap_nn_tpu_torch.inference.loaders import build_model

    _, model = build_model(PConfig.load_yaml(pdir / "training_config.yaml"), pdir)
    state = flax_to_torch_state(params, model)
    torch.save({"state_dict": {f"model.{k}": v for k, v in state.items()}, "epoch": 0,
                "best_val_loss": 0.0}, pdir / "best.ckpt")
    return pdir, jdir


def build_case(root, name, backbone, model_type, frames, seed):
    jcfg = JConfig.from_dict(json.loads(json.dumps(dir_config(backbone, model_type))))
    bb_type = next(iter(backbone))
    fm = FlaxModel.from_config(bb_type, j_backbone_config(jcfg), j_head_config(jcfg),
                               model_type)
    params = conditioned_params(fm, frames, model_type, seed)
    return write_dirs(root, name, dir_config(backbone, model_type), params)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    root = tmp_path_factory.mktemp("dirs")
    frames = blob_frames(N_FRAMES + 2, seed=4)
    snap = root / "cnv2_snapshot"
    snap.mkdir()
    (snap / "config.json").write_text(json.dumps(PRETRAINED_CONFIGS["convnextv2"]))
    pretrained = {"pretrained": {"model_name": str(snap), "output_stride": 2, "weights": False}}
    centroid = build_case(root, "cn_centroid", CONVNEXT, "centroid", frames, 1)
    ci = build_case(root, "cn_ci", CONVNEXT, "centered_instance", frames, 2)
    return {
        "topdown_convnext": ([centroid[0], ci[0]], [centroid[1], ci[1]], {}),
        "bottomup_swint": (*[[d] for d in build_case(root, "sw_bu", SWINT, "bottomup",
                                                     frames, 3)],
                           {"min_line_scores": -0.5}),
        "single_instance_pretrained": (*[[d] for d in build_case(
            root, "pt_si", pretrained, "single_instance", frames, 5)], {}),
    }


def _labels(io, frames):
    video = FrameVideo(frames)
    return io.Labels([io.LabeledFrame(video, i) for i in range(len(frames))])


def assert_labels_close(got, want, min_found=3):
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    n = 0
    for g, w in zip(got, want):
        assert len(g.instances) == len(w.instances)
        for gi, wi in zip(g.instances, w.instances):
            np.testing.assert_array_equal(np.isnan(gi.points), np.isnan(wi.points))
            np.testing.assert_allclose(gi.points, wi.points, atol=1e-3, rtol=0)
            np.testing.assert_allclose(gi.point_scores, wi.point_scores, atol=1e-4, rtol=0)
            np.testing.assert_allclose(gi.score, wi.score, atol=1e-4, rtol=0)
            n += int(np.isfinite(gi.points).any())
    assert n >= min_found


@pytest.mark.parametrize("case", ["topdown_convnext", "bottomup_swint",
                                  "single_instance_pretrained"])
def test_dir_predictions_match_the_jax_package(cases, case):
    pdirs, jdirs, kw = cases[case]
    frames = blob_frames(N_FRAMES, seed=9)
    for d in pdirs:  # the dir loads strictly, every key from its checkpoint
        saved = torch.load(d / "best.ckpt")["state_dict"]
        assert set(load_model(d).model.state_dict()) == {k[len("model."):] for k in saved}
    got = prun.predict(_labels(pio, frames), pdirs, batch_size=4, device="cpu", **kw)
    want = jax_predict(_labels(jio, frames), jdirs, batch_size=4, **kw)
    assert_labels_close(got, want)


def test_cli_predict_on_a_swint_dir(cases, tmp_path):
    pdirs, _, kw = cases["bottomup_swint"]
    frames = blob_frames(N_FRAMES, seed=10)
    clip = tmp_path / "clip.avi"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"MJPG"), 10, (HW, HW))
    for f in frames:
        writer.write(np.repeat(f, 3, axis=-1))
    writer.release()
    out = tmp_path / "out.slp"
    argv = ["predict", "-i", str(clip), "-m", str(pdirs[0]), "-o", str(out), "--device", "cpu",
            "--min_line_scores", str(kw["min_line_scores"])]
    assert pcli.main(argv) == 0
    want = prun.predict(str(clip), pdirs, device="cpu", **kw)
    assert_labels_close(load_slp(out), want, min_found=1)


def test_fused_kernel_stays_in_the_unet(cases):
    """The fused double conv is routed into a UNet backbone only: a ConvNeXt
    model's decoder keeps its plain convs on a backend that fuses."""
    model = load_model(cases["topdown_convnext"][0][0]).model
    backend = TorchBackend(model, None, fused_convs=True, device="cpu")
    assert not any(getattr(m, "use_fused", False) for m in backend.model.modules())
    from sleap_nn_tpu_torch.models.model import Model
    from sleap_nn_tpu_torch.config.model_config import UNetConfig
    from types import SimpleNamespace as ns

    unet = Model.from_config("unet", UNetConfig(filters=4, max_stride=8, output_stride=2),
                             ns(confmaps=ns(anchor_part=None, sigma=3.0, output_stride=2,
                                            loss_weight=None)), "centroid")
    maybe_fuse_convs(unet, True)
    assert any(getattr(m, "use_fused", False) for m in unet.modules())
