"""Port parity: export to ``model.pt2`` and prediction from an export dir.

The port's trainer writes one narrow dir per model type (UNet filters 8,
max_stride 8, 64x64 blob frames, 3-node chain, one train step on the CPU),
conditioned as ``tests/test_torch_model_dir.py`` and
``test_torch_segmentation_dirs.py`` condition theirs (biases zeroed, heads
scaled), so that no float-noise tie decides a peak. Each of the eight
single-model types and the two top-down composites is exported on the CPU;
its loaded program, on seeded uint8 blob frames (crops for the crop
models), is held to the JAX package's ``_build_wrapper`` function (for a
composite, ``_build_composite_wrapper``'s ``layer._full``) on the same dir:
integer, boolean and index outputs exactly, f32 outputs to 1e-4 with NaN
and infinities placed alike. ``from_export_dir`` through ``run.predict``
gives the JAX package's ``Labels`` from the source dirs. The registered
operators pass ``torch.library.opcheck`` on their CPU paths.
"""

import copy
import json
import logging
import shutil

import jax
import numpy as np
import pytest
import torch

from sleap_nn_tpu.export import exporter as jexp
from sleap_nn_tpu.inference.loaders import load_model as jax_load_model
from sleap_nn_tpu.inference.run import predict as jax_predict
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu_torch.config import TrainingJobConfig as PConfig
from sleap_nn_tpu_torch.export import (
    ExportMetadata,
    export_model,
    load_exported_model,
    verify_export_numerics,
)
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.ops import library
from sleap_nn_tpu_torch.training import ModelTrainer
from tests.test_torch_model_dir import (
    CROP,
    HW,
    N_FRAMES,
    FrameVideo,
    condition,
    config_dict,
    frames_and_labels,
)
from tests.test_torch_multiclass import head_configs
from tests.test_torch_segmentation_dirs import condition_seg, seg_config
from tests.test_torch_topdown import blob_frames
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

BATCH = 4
SINGLE = ("single_instance", "centroid", "centered_instance", "bottomup",
          "multi_class_bottomup", "centered_instance_segmentation", "semantic_segmentation",
          "bottomup_segmentation")
COMPOSITES = {"topdown": ("centroid", "centered_instance"),
              "multi_class_topdown": ("centroid", "multi_class_topdown")}
CROP_TYPES = ("centered_instance", "centered_instance_segmentation")
PAF_KNOBS = {"n_points": 10, "max_edge_length_ratio": 0.25, "dist_penalty_weight": 1.0}
CM_HEADS = {"multi_class_bottomup": "MultiInstanceConfmapsHead",
            "multi_class_topdown": "CenteredInstanceConfmapsHead"}


def _condition_identity(model, frames, model_type):
    """:func:`condition` for the identity types' confmap heads."""
    head = CM_HEADS[model_type]
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.zero_()
        model.eval()
        maps = model(torch.from_numpy(frames / np.float32(255.0)))[head].numpy()
        top, bottom = maps.max(axis=(0, 1, 2)), maps.min(axis=(0, 1, 2))
        conv = next(layer[head][0] for layer in model.head_layers if head in layer)
        conv.weight.div_(torch.from_numpy(np.maximum(top - bottom, 1e-12))[:, None, None, None])


def _config(model_type, root):
    if model_type in CM_HEADS:
        d = config_dict("centroid", root)
        d["trainer_config"]["run_name"] = model_type
        d["model_config"]["head_configs"] = {model_type: head_configs(model_type)}
        if model_type == "multi_class_topdown":
            d["data_config"]["preprocessing"] = {"crop_size": CROP}
        return d
    if "segmentation" in model_type:
        return seg_config(model_type, root)
    return config_dict(model_type, root)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Per model type, a conditioned dir the port's trainer wrote."""
    root = tmp_path_factory.mktemp("export_runs")
    out = {}
    for mt in SINGLE + ("multi_class_topdown",):
        frames, labels = frames_and_labels(pio, 1 if mt == "single_instance" else 2)
        if mt in CM_HEADS:
            tracks = [pio.Track(name="a"), pio.Track(name="b")]
            for lf in labels.labeled_frames:
                for inst, track in zip(lf.instances, tracks):
                    inst.track = track
            labels.tracks = tracks
        trainer = ModelTrainer.get_model_trainer_from_config(
            PConfig.from_dict(copy.deepcopy(_config(mt, root))), [labels], device="cpu")
        trainer.train()
        cond = root / "conditioned" / mt
        shutil.copytree(trainer.ckpt_dir, cond)
        if mt in CM_HEADS:
            _condition_identity(trainer.model, frames, mt)
        elif "segmentation" in mt:
            seg_frames = frames
            if mt == "centered_instance_segmentation":
                seg_frames = np.zeros((4, CROP, CROP, 1), np.uint8)
                seg_frames[:, 4:28, 4:28] = frames[:4, 20:44, 20:44]
            condition_seg(trainer.model, seg_frames)
        else:
            condition(trainer.model, frames, mt)
        trainer.ckpt_dir = cond
        trainer.save_checkpoint("best.ckpt")
        out[mt] = cond
    return out


def _sources(dirs, name):
    return [dirs[t] for t in COMPOSITES[name]] if name in COMPOSITES else [dirs[name]]


def _input(name, seed=3):
    """Seeded uint8 blob frames, or centred crops of them for a crop model."""
    frames = blob_frames(BATCH, seed=seed)
    if name in CROP_TYPES:
        return np.ascontiguousarray(frames[:, 16:16 + CROP, 16:16 + CROP])
    return frames


@pytest.fixture(scope="module")
def exports(dirs, tmp_path_factory):
    """Per export name and precision: the export dir (written on the CPU)."""
    root = tmp_path_factory.mktemp("exports")
    cache = {}

    def get(name, precision="fp32", **kw):
        key = (name, precision, tuple(sorted(kw.items())))
        if key not in cache:
            src = _sources(dirs, name)
            cache[key] = export_model(src if len(src) > 1 else src[0],
                                      output_dir=root / f"{name}_{precision}_{len(cache)}",
                                      batch_size=BATCH, precision=precision, device="cpu",
                                      **kw)
        return cache[key]

    return get


def _jax_fn(dirs, name):
    src = [str(d) for d in _sources(dirs, name)]
    if name in COMPOSITES:
        _, fn, shape, outputs = jexp._build_composite_wrapper(src, 0.2, BATCH, 200, 20)
    else:
        fn, shape, outputs = jexp._build_wrapper(jax_load_model(src[0]), 0.2, BATCH, 200,
                                                 paf_knobs=PAF_KNOBS)
    return jax.jit(fn), shape, outputs


def assert_outputs_match(got, want, atol=1e-4):
    """Integer, boolean and index outputs exactly; floats to ``atol`` with
    NaN and infinities placed alike."""
    assert set(got) == set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        g, w = g.astype(np.float64), w.astype(np.float64)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=k)
        np.testing.assert_array_equal(np.isinf(g) & (g > 0), np.isinf(w) & (w > 0), err_msg=k)
        np.testing.assert_array_equal(np.isinf(g) & (g < 0), np.isinf(w) & (w < 0), err_msg=k)
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], atol=atol, rtol=0, err_msg=k)


def _numpy(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


@pytest.mark.parametrize("name", SINGLE + tuple(COMPOSITES))
def test_loaded_program_matches_the_jax_wrapper(dirs, exports, name):
    out_dir = exports(name)
    call, meta = load_exported_model(out_dir, device="cpu")
    fn, shape, outputs = _jax_fn(dirs, name)
    x = _input(name)
    assert tuple(meta.input_shape) == tuple(shape) == x.shape
    assert tuple(meta.output_names) == tuple(outputs)
    want = jax.device_get(fn(x))
    got = _numpy(call(x))
    assert_outputs_match(got, {k: want[k] for k in got})
    assert set(outputs) <= set(got)
    # The program found something to compare: peaks, masks or foreground.
    found = lambda v: v.astype(bool)  # noqa: E731
    signal = {"pred_keypoints": np.isfinite, "pred_centroids": np.isfinite,
              "grouped_mask": found, "valid": found, "instance_masks": found,
              "seg_probs": lambda v: v > 0.5, "fg": lambda v: v > 0.5}
    key = next(k for k in signal if k in got)
    assert np.any(signal[key](got[key])), key


def test_program_holds_the_registered_operators(exports):
    counts = {}
    for name in ("bottomup", "topdown", "single_instance"):
        ep = torch.export.load(str(exports(name) / "model.pt2"))
        for node in ep.graph.nodes:
            target = str(node.target)
            if target.startswith("sleap_nn_tpu_torch."):
                counts[(name, target.split(".")[1])] = counts.get(
                    (name, target.split(".")[1]), 0) + 1
    assert counts[("bottomup", "nms_scores")] == 1
    assert counts[("bottomup", "paf_line_scores")] == 1
    assert counts[("topdown", "nms_scores")] == 1
    assert counts[("single_instance", "fused_double_conv3x3")] >= 3
    assert counts[("topdown", "fused_double_conv3x3")] == \
        2 * counts[("single_instance", "fused_double_conv3x3")]
    assert ("single_instance", "nms_scores") not in counts  # global peaks: no NMS


@pytest.mark.parametrize("name", ("single_instance", "centroid", "topdown", "multi_class_topdown",
                                  "semantic_segmentation"))
def test_bf16_program_stays_near_fp32(exports, name):
    """bf16 against fp32 where each output row is one peak or map of its
    own. (A random-weight bottom-up head's maps hold many near-flat local
    maxima, which bf16 rounding moves among a node's peak slots.)"""
    x = _input(name)
    f32 = _numpy(load_exported_model(exports(name), device="cpu")[0](x))
    bf16 = _numpy(load_exported_model(exports(name, "bf16"), device="cpu")[0](x))
    assert set(f32) == set(bf16)
    for k, v in f32.items():
        if v.dtype.kind in "biu":
            continue
        fin = np.isfinite(v) & np.isfinite(bf16[k])
        # bf16 keeps 8 bits: maps to 0.05, coordinates to half a pixel.
        tol = 0.5 if k in ("pred_keypoints", "pred_centroids", "grouped_peaks") else 0.1
        assert np.abs(v[fin] - bf16[k][fin]).max(initial=0) <= tol, k


def test_metadata_matches_the_jax_export(dirs, exports, tmp_path):
    out = exports("bottomup")
    jout = jexp.export_model(str(dirs["bottomup"]), output_dir=tmp_path / "jax", batch_size=BATCH,
                             verify=False)
    got = json.loads((out / "metadata.json").read_text())
    want = json.loads((jout / "metadata.json").read_text())
    skip = {"artifact", "format", "artifact_sha256"}
    assert set(got) == set(want)
    assert {k: v for k, v in got.items() if k not in skip} == \
        {k: v for k, v in want.items() if k not in skip}
    assert (got["artifact"], got["format"]) == ("model.pt2", "torch_export_pt2")
    assert ExportMetadata.from_json((out / "metadata.json").read_text()).input_shape == \
        [BATCH, HW, HW, 1]
    assert (out / "training_config.yaml").read_text() == \
        (dirs["bottomup"] / "training_config.yaml").read_text()
    topdown = exports("topdown")
    assert (topdown / "training_config.yaml").read_text() == \
        (dirs["centered_instance"] / "training_config.yaml").read_text()


def test_input_geometry_overrides_change_baked_shape(dirs, exports, tmp_path):
    out = exports("bottomup", input_height=48, input_width=80, input_scale=1.0, verify=False)
    jout = jexp.export_model(str(dirs["bottomup"]), output_dir=tmp_path / "jax", batch_size=BATCH,
                             verify=False, input_height=48, input_width=80, input_scale=1.0)
    got = ExportMetadata.from_json((out / "metadata.json").read_text())
    want = jexp.ExportMetadata.from_json((jout / "metadata.json").read_text())
    assert list(got.input_shape) == list(want.input_shape) == [BATCH, 48, 80, 1]
    call, _ = load_exported_model(out, device="cpu")
    assert call(np.zeros((BATCH, 48, 80, 1), np.uint8))["paf_scores"].shape[0] == BATCH


def test_verify_reports_each_output(dirs, exports):
    out = exports("centroid")
    from sleap_nn_tpu_torch.export.exporter import _build_wrapper
    from sleap_nn_tpu_torch.inference.loaders import load_model

    program, shape, outputs = _build_wrapper(load_model(dirs["centroid"]), 0.2, BATCH, 200,
                                             device="cpu")
    report = verify_export_numerics(out, program, _input("centroid"), device="cpu")
    assert report["ok"] and set(report["max_abs_diff"]) == set(outputs)
    assert max(report["max_abs_diff"].values()) == 0.0  # the same CPU code


def _copy_dir(src, dst, **meta_changes):
    dst.mkdir()
    meta = json.loads((src / "metadata.json").read_text())
    meta.update(meta_changes)
    (dst / "metadata.json").write_text(json.dumps(meta))
    if (src / "model.pt2").exists():
        shutil.copy(src / "model.pt2", dst / "model.pt2")
    return dst


@pytest.mark.parametrize("case", ["missing_metadata", "unknown_runtime", "onnx_runtime",
                                  "stablehlo_runtime", "savedmodel_runtime", "runtime_mismatch",
                                  "missing_artifact", "hash_mismatch", "tampered_model_type",
                                  "jax_format_dir"])
def test_load_errors(exports, tmp_path, case):
    src = exports("single_instance")
    if case == "missing_metadata":
        with pytest.raises(FileNotFoundError, match="metadata.json"):
            load_exported_model(tmp_path, device="cpu")
    elif case in ("unknown_runtime", "onnx_runtime"):
        with pytest.raises(ValueError, match="Unknown runtime"):
            load_exported_model(src, runtime="tflite" if case == "unknown_runtime" else "onnx",
                                device="cpu")
    elif case in ("stablehlo_runtime", "savedmodel_runtime"):
        with pytest.raises(ValueError, match="JAX package"):
            load_exported_model(src, runtime=case.split("_")[0], device="cpu")
    elif case == "runtime_mismatch":
        broken = _copy_dir(src, tmp_path / "b", artifact="other.pt2")
        with pytest.raises(ValueError, match="metadata names"):
            load_exported_model(broken, runtime="pt2", device="cpu")
    elif case == "missing_artifact":
        broken = _copy_dir(src, tmp_path / "b")
        (broken / "model.pt2").unlink()
        with pytest.raises(FileNotFoundError):
            load_exported_model(broken, device="cpu")
    elif case == "hash_mismatch":
        broken = _copy_dir(src, tmp_path / "b")
        blob = bytearray((broken / "model.pt2").read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        (broken / "model.pt2").write_bytes(bytes(blob))
        with pytest.raises(ValueError, match="hash mismatch"):
            load_exported_model(broken, device="cpu")
    elif case == "tampered_model_type":
        broken = _copy_dir(src, tmp_path / "b", model_type="hypermodel")
        with pytest.raises(ValueError, match="hypermodel"):
            Predictor.from_export_dir(broken, device="cpu")
    else:  # a dir the JAX package's export wrote
        broken = _copy_dir(src, tmp_path / "b", artifact="model.stablehlo",
                           format="jax_export_stablehlo")
        (broken / "model.stablehlo").write_bytes(b"\0")
        with pytest.raises(ValueError, match="JAX package"):
            load_exported_model(broken, device="cpu")
        with pytest.raises(ValueError, match="JAX package"):
            prun.predict(pio.Labels([]), [broken], device="cpu")


@pytest.mark.parametrize("fmt", ["stablehlo", "savedmodel"])
def test_jax_formats_refused_at_export(dirs, tmp_path, fmt):
    with pytest.raises(ValueError, match="JAX package"):
        export_model(dirs["centroid"], output_dir=tmp_path, fmt=fmt, device="cpu")


@pytest.mark.parametrize("name", CROP_TYPES)
def test_from_export_dir_refuses_crop_models(exports, name):
    with pytest.raises(NotImplementedError, match="topdown composite"):
        Predictor.from_export_dir(exports(name), device="cpu")


PREDICT_CASES = ("single_instance", "centroid", "bottomup", "multi_class_bottomup", "topdown",
                 "multi_class_topdown", "semantic_segmentation", "bottomup_segmentation")
KW = {"bottomup": {"min_line_scores": -0.5}}


def _labels(io, frames):
    video = FrameVideo(frames)
    return io.Labels([io.LabeledFrame(video, i) for i in range(len(frames))])


@pytest.mark.parametrize("name", PREDICT_CASES)
def test_predict_from_export_dir_matches_jax_from_model_dirs(dirs, exports, name):
    frames = blob_frames(N_FRAMES, seed=9)
    got = prun.predict(_labels(pio, frames), [exports(name)], batch_size=BATCH, device="cpu",
                       **KW.get(name, {}))
    want = jax_predict(_labels(jio, frames), [str(d) for d in _sources(dirs, name)],
                       batch_size=BATCH, **KW.get(name, {}))
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    n = 0
    for g, w in zip(got.labeled_frames, want.labeled_frames):
        assert len(g.instances) == len(w.instances) and len(g.masks) == len(w.masks)
        for gi, wi in zip(g.instances, w.instances):
            np.testing.assert_array_equal(np.isnan(gi.points), np.isnan(wi.points))
            inside = ((wi.points >= 0) & (wi.points < HW)).all()
            np.testing.assert_allclose(gi.points, wi.points, rtol=0,
                                       atol=1e-4 if inside else 1e-2)
            np.testing.assert_allclose(gi.score, wi.score, rtol=0, atol=1e-4)
            assert getattr(gi.track, "name", None) == getattr(wi.track, "name", None)
            n += 1
        for gm, wm in zip(g.masks, w.masks):
            np.testing.assert_array_equal(gm.mask, wm.mask)
            assert gm.scale == pytest.approx(wm.scale)
            n += 1
    assert n >= 3


def test_export_dir_runs_tracking_and_warns_on_baked_knobs(exports, caplog):
    frames = blob_frames(N_FRAMES, seed=9)
    out = exports("topdown")
    with caplog.at_level(logging.WARNING, logger="sleap_nn_tpu_torch"):
        tracked = prun.predict(_labels(pio, frames), [out], batch_size=BATCH, device="cpu",
                               tracking=True, peak_threshold=0.05, max_peaks=10)
    msgs = [r.getMessage() for r in caplog.records if "baked" in r.getMessage()]
    assert sorted(m.split("=")[0] for m in msgs) == ["max_peaks", "peak_threshold"]
    plain = prun.predict(_labels(pio, frames), [out], batch_size=BATCH, device="cpu")
    want = prun.run_tracker(plain)
    assert [[i.track.name for i in lf.instances] for lf in tracked] == \
        [[i.track.name for i in lf.instances] for lf in want]


@pytest.mark.parametrize("op", sorted(library.OPS))
def test_registered_operator_passes_opcheck(op):
    rng = np.random.default_rng(0)
    t = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    if op == "fused_double_conv3x3":
        args = (t(2, 8, 8, 3), t(3, 3, 3, 4), t(4), t(3, 3, 4, 5), None, "relu")
    elif op == "nms_scores":
        args = (t(2, 9, 7, 3), 0.1, 3)
    else:
        peaks = torch.from_numpy(rng.uniform(0, 30, (2, 3, 4, 2)).astype(np.float32))
        args = (t(2, 8, 8, 4), peaks, torch.from_numpy(rng.random((2, 3, 4)) < 0.7),
                torch.tensor([[0, 1], [1, 2]], dtype=torch.int32),
                torch.linspace(0, 1, 5), 4.0, 8.0, 1.0)
    torch.library.opcheck(library.OPS[op].default, args)
    # The operator computes what the wrapper computes.
    from sleap_nn_tpu_torch.ops import fused_conv, kernels

    wrapper = {"fused_double_conv3x3": fused_conv.fused_double_conv3x3,
               "nms_scores": kernels.nms_scores, "paf_line_scores": kernels.paf_line_scores}[op]
    torch.testing.assert_close(library.OPS[op](*args), wrapper(*args), rtol=0, atol=0)


def test_cli_export_then_predict_from_the_export_dir(dirs, tmp_path):
    from sleap_nn_tpu_torch import cli as pcli
    from sleap_nn_tpu_torch.io.slp import load_slp

    frames = blob_frames(N_FRAMES, seed=9)
    src = tmp_path / "src.slp"
    _labels(pio, frames).save(str(src), embed=True)
    out = tmp_path / "exp"
    assert pcli.main(["export", str(dirs["centroid"]), str(dirs["centered_instance"]), "-o",
                      str(out), "--batch-size", str(BATCH), "--device", "cpu"]) == 0
    assert pcli.main(["predict", "-i", str(src), "-m", str(out), "--device", "cpu",
                      "--runtime", "pt2", "-o", str(tmp_path / "p.slp")]) == 0
    got = load_slp(str(tmp_path / "p.slp"))
    want = prun.predict(load_slp(str(src)), [out], batch_size=BATCH, device="cpu")
    assert [len(lf.instances) for lf in got] == [len(lf.instances) for lf in want]
    with pytest.raises(ValueError, match="JAX package"):
        pcli.main(["predict", "-i", str(src), "-m", str(out), "--device", "cpu",
                   "--runtime", "stablehlo"])
