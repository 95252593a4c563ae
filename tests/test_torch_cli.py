"""Port parity: the command line (``sleap_nn_tpu_torch/cli.py``) against the
JAX package's click group ``sleap_nn_tpu.cli.cli``.

- Parser parity: every command, option string (dashed and underscored
  aliases, short flags, ``--x/--no-x`` pairs), default, repeatable and
  multi-value option, flag, choice and hidden option of the click group is
  read off its params and held against the port's argparse parser;
  ``--device``'s ``tpu`` -> ``cuda`` is the only difference.
- Kwargs parity: for a table of argument lines per command (aliases, flag
  pairs, ``--frames`` forms, filters, tracking knobs, config overrides),
  both packages' ``predict`` / ``run_training`` / ``run_evaluation`` /
  ``run_tracker`` are replaced by recorders; they receive equal
  arguments, and usage errors give the same exit codes.
- End to end on the CPU (``--device cpu``), tiny models: ``train`` from a
  YAML whose labels the JAX package's ``save_slp`` wrote, ``predict``
  top-down and bottom-up to ``.slp``, ``track-only`` and ``eval``, by the
  JAX command (click's ``CliRunner``) and ``cli.main`` of the port, with
  outputs equal at the tolerances of ``tests/test_torch_model_dir.py``
  (points 1e-4 top-down, 1e-5 bottom-up; counts, validity and NaN
  placement exact). ``info`` prints the JAX command's sections and rows;
  ``system`` runs on the CPU. One subprocess runs ``python -m
  sleap_nn_tpu_torch.cli predict`` with h5py blocked.
"""

import contextlib
import copy
import functools
import json
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace as ns

import click
import numpy as np
import pytest
import yaml
from click.testing import CliRunner

import sleap_nn_tpu.evaluation as jevaluation
import sleap_nn_tpu.inference as jinference
import sleap_nn_tpu.tracking as jtracking
import sleap_nn_tpu.train as jtrain
from sleap_nn_tpu import cli as jcli
from sleap_nn_tpu.config.base import to_dict as jax_to_dict
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.io.slp import load_slp as jax_load_slp
from sleap_nn_tpu_torch import cli as pcli
from sleap_nn_tpu_torch import evaluation as pevaluation
from sleap_nn_tpu_torch import tracking as ptracking
from sleap_nn_tpu_torch import train as ptrain
from sleap_nn_tpu_torch.config.base import to_dict as port_to_dict
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io.slp import load_slp
from sleap_nn_tpu_torch.model_info import model_info_sections
from tests.test_torch_model_dir import FrameVideo, dirs  # noqa: F401  (dirs: a fixture)
from tests.test_torch_pipeline import cfg_dict
from tests.test_torch_run_video import write_clip
from tests.test_torch_topdown import blob_frames
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
ATOL = {"topdown": 1e-4, "bottomup": 1e-5}


def _device(value):
    return "cuda" if value == "tpu" else value


# -- parser parity ----------------------------------------------------------------


def _click_type(param):
    if isinstance(param.type, click.Choice):
        return "choice"
    return param.type.name


def _port_type(prm):
    if prm.exists:
        return "path"
    if prm.choices is not None:
        return "choice"
    if prm.is_flag:
        return "boolean"
    return {int: "integer", float: "float", None: "text", str: "text",
            pcli._comma_floats: "floats", pcli._int_list: "text"}[prm.type]


def _click_commands():
    ctx = click.Context(jcli.cli)
    return {name: jcli.cli.get_command(ctx, name) for name in jcli.cli.list_commands(ctx)}


# Choices and defaults where the port differs on purpose: its export is a
# torch.export program (pt2); the JAX package's formats parse, and raise.
PORT_CHOICES = {("export", "fmt"): ["pt2", "stablehlo", "savedmodel"],
                **{(cmd, "runtime"): ["auto", "pt2", "stablehlo", "savedmodel"]
                   for cmd in ("predict", "track", "infer")}}
PORT_DEFAULTS = {("export", "fmt"): "pt2"}


@pytest.mark.parametrize("name", sorted(_click_commands()))
def test_parser_parity_with_the_click_group(name):
    want = _click_commands()[name]
    got = pcli.COMMANDS[name]
    assert got.hidden == want.hidden
    click_params = [p for p in want.params if p.name != "help"]
    assert [p.name for p in got.params] == [p.name for p in click_params]
    parser = got.parser()
    for prm, p in zip(got.params, click_params):
        assert isinstance(prm, pcli.Arg) == isinstance(p, click.Argument), p.name
        if isinstance(p, click.Argument):
            assert (prm.required, prm.nargs) == (p.required, p.nargs), p.name
            assert prm.exists == bool(getattr(p.type, "exists", False)), p.name
            continue
        assert prm.opts == p.opts and prm.secondary_opts == p.secondary_opts, p.name
        for opt in prm.opts + prm.secondary_opts:  # the built parser takes each string
            assert parser._option_string_actions[opt].dest == p.name, opt
        assert (prm.multiple, prm.nargs, prm.is_flag, prm.hidden, prm.required) == \
            (p.multiple, p.nargs, p.is_flag, p.hidden, p.required), p.name
        assert _port_type(prm) == _click_type(p), p.name
        assert prm.exists == bool(getattr(p.type, "exists", False)), p.name
        if isinstance(p.type, click.Choice):
            choices = PORT_CHOICES.get((name, p.name), [_device(c) for c in p.type.choices])
            assert prm.choices == choices, p.name
            assert prm.case_sensitive == p.type.case_sensitive, p.name
        assert bool(prm.help) == bool(p.help), p.name


def _minimal_argv(name, tmp_path):
    gt = tmp_path / "gt.slp"
    gt.touch()
    return {"predict": ["-i", "x.mp4"], "infer": ["-i", "x.mp4"], "track": ["-i", "x.mp4"],
            "track-only": ["-i", "x.slp"], "eval": ["-g", str(gt), "-p", str(gt)],
            "sam": ["-i", str(gt), "--mask-backend", "sam"], "info": [str(tmp_path)],
            "export": [str(tmp_path)], "config-generate": [str(gt)]}.get(name, [])


@pytest.mark.parametrize("name", sorted(_click_commands()))
def test_defaults_match_the_click_group(name, tmp_path):
    """What each option holds when it is not given: click's parsed value,
    against the port parser's."""
    argv = _minimal_argv(name, tmp_path)
    want = _click_commands()[name].make_context(name, list(argv)).params
    got = pcli.COMMANDS[name].parse(list(argv))
    assert got == {k: PORT_DEFAULTS.get((name, k), _device(v)) for k, v in want.items()}


def test_group_level_behaviour_matches(capsys):
    runner = CliRunner()
    for argv in ([], ["--version"], ["--help"], ["nope"], ["predict"], ["train", "--config-dir"]):
        assert pcli.main(argv) == runner.invoke(jcli.cli, argv).exit_code, argv
    capsys.readouterr()
    assert pcli.main(["--version"]) == 0
    assert capsys.readouterr().out.strip() == "sleap-nn-tpu-torch, version 0.1.0"


# -- kwargs parity ------------------------------------------------------------------


class Recorder:
    def __init__(self, ret=None):
        self.calls = []
        self.ret = ret

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        return self.ret(*args, **kwargs) if callable(self.ret) else self.ret


def _norm(value):
    if callable(value):  # the --gui progress callback: each package's own
        return "callable"
    if hasattr(value, "enabled") and hasattr(value, "min_node_count"):  # FilterConfig
        return ("FilterConfig", sorted(vars(value).items()))
    if isinstance(value, (list, tuple)):
        return [_norm(v) for v in value]
    return value


def _norm_kwargs(kwargs):
    return {k: (_device(v) if k == "device" else _norm(v)) for k, v in kwargs.items()}


@pytest.fixture
def recorders(monkeypatch):
    rec = ns(jax_predict=Recorder(lambda *a, **k: jio.Labels()),
             port_predict=Recorder(lambda *a, **k: pio.Labels()),
             jax_train=Recorder(ns(ckpt_dir=None)), port_train=Recorder(ns(ckpt_dir=None)),
             jax_eval=Recorder(), port_eval=Recorder(),
             jax_track=Recorder(lambda labels, **k: labels),
             port_track=Recorder(lambda labels, **k: labels))
    monkeypatch.setattr(jinference, "predict", rec.jax_predict)
    monkeypatch.setattr(prun, "predict", rec.port_predict)
    monkeypatch.setattr(jtrain, "run_training", rec.jax_train)
    monkeypatch.setattr(ptrain, "run_training", rec.port_train)
    monkeypatch.setattr(jevaluation, "run_evaluation", rec.jax_eval)
    monkeypatch.setattr(pevaluation, "run_evaluation", rec.port_eval)
    monkeypatch.setattr(jtracking, "run_tracker", rec.jax_track)
    monkeypatch.setattr(ptracking, "run_tracker", rec.port_track)
    return rec


def _both(argv):
    """Exit codes of the JAX command (through CliRunner) and the port's
    (``--device tpu`` given to the port as ``cuda``)."""
    want = CliRunner().invoke(jcli.cli, argv)
    if want.exit_code not in (0, 2) and want.exception is not None:
        raise want.exception
    return pcli.main([_device(a) for a in argv]), want.exit_code


PREDICT_LINES = [
    ["-i", "x.mp4", "-m", "a"],
    ["--data_path", "x.slp", "--model_paths", "a", "--model-paths", "b", "--output_path", "o.slp",
     "--batch_size", "8", "--peak_threshold", "0.3"],
    ["-i", "x.mp4", "-m", "a", "--peak-conf-threshold", "0.1", "-b", "2", "-n", "3",
     "--max-peaks", "50", "--refinement", "local", "--integral_patch_size", "7"],
    ["-i", "x.mp4", "-m", "a", "--use_bf16", "--no-use-bf16", "--host-resize",
     "--ensure-rgb", "--no-ensure_grayscale", "--exclude_user_labeled",
     "--keep-empty-frames", "--all_frames", "--no-restore-source-videos"],
    ["-i", "x.mp4", "-m", "a", "--use-bf16", "--no-empty-frames", "--only-labeled-frames",
     "--only_predicted_frames", "--only-suggested-frames", "--include_user_labeled"],
    ["-i", "x.mp4", "-m", "a", "--frames", "0-10"],
    ["-i", "x.mp4", "-m", "a", "--frames", "1,-20"],
    ["-i", "x.mp4", "-m", "a", "--frames", "3,5,7", "--video-index", "1",
     "--video-path-map", "a=b,c=d", "--video-dataset", "box",
     "--video_input_format", "channels_first"],
    ["-i", "x.mp4", "-m", "a", "--filter-overlapping", "--filter_overlapping_method", "oks",
     "--filter-overlapping-threshold", "0.5", "--filter-min-visible-nodes", "3",
     "--filter-min-instance-score", "0.2", "--filter_min_node_confidence", "0.1",
     "--filter-min-visible-node-fraction", "0.5", "--filter-min-mean-node-score", "0.3",
     "--filter-min-centroid-distance", "4"],
    ["-i", "x.mp4", "-m", "a", "--filter_overlapping_method", "oks"],
    ["-i", "x.mp4", "-m", "a", "-t", "--max-tracks", "3", "--use-kalman",
     "--kf-node-indices", "0,2", "--scoring-method", "iou", "--post-connect-single-breaks",
     "-n", "4", "--candidates_method", "local_queues", "--features", "centroids",
     "--tracking-scoring-method", "oks", "--robust_best_instance", "0.5",
     "--track-matching-method", "greedy", "--of-img-scale", "0.5", "--oks-stddev", "0.05"],
    ["-i", "x.mp4", "-m", "a", "--tracking", "--tracking-pre-cull-to-target", "2",
     "--tracking_pre_cull_iou_threshold", "0.3", "--tracking-clean-instance-count", "2",
     "--tracking-clean-iou-threshold", "0.2", "--tracking-use-flow", "--kf-track-features",
     "keypoints", "--tracking_target_instance_count", "5", "--no-tracking"],
    ["-i", "x.pkg.slp", "-m", "a", "--embed", "AUTO"],
    ["-i", "x.slp", "-m", "a", "--embed", "True", "--output-format", "slp",
     "--output_format", "analysis_h5"],
    ["-i", "x.mp4", "-m", "a", "--device", "tpu", "--queue-maxsize", "8"],
    ["-i", "x.mp4", "-m", "a", "-d", "cpu", "--paf-workers", "2"],
    ["-i", "x.mp4", "-m", "a", "--cpu-workers", "2", "--device", "auto"],
    ["-i", "x.mp4", "-m", "a", "--merge-thresholds", "0.9,0.5", "--merge-fragments",
     "--mask-output", "polygon", "--min_mask_area", "10", "--no-mask-cleanup"],
    ["-i", "x.mp4", "-m", "a", "--stream-to-file", "s.slp", "--write-interval", "10"],
    ["-i", "x.slp", "--mask-backend", "SAM3", "--overlay-path", "o.png"],
    ["-i", "x.slp", "--mask-backend", "sam", "--sam-checkpoint", "ck.pth"],
    ["-i", "x.mp4", "-m", "a", "--headers", '{"A": "b"}', "--stream-mode", "stream"],
    ["-i", "x.mp4", "-m", "a", "--centroid-only", "--centroid_output", "both",
     "--centroid-peak-threshold", "0.4", "--crop-size", "32", "--anchor-part", "n0",
     "--max-height", "64", "--max_width", "80", "--input-scale", "0.5",
     "--backbone-ckpt-path", "b.ckpt", "--head_ckpt_path", "h.ckpt", "--runtime", "auto",
     "--no-data-parallel", "--profile-dir", "p", "--gui"],
    ["-i", "x.mp4", "-m", "a", "--max-edge-length-ratio", "0.5", "--dist_penalty_weight",
     "2", "--n-points", "5", "--min-instance-peaks", "1", "--min_line_scores", "-0.5"],
    ["-i", "x.mp4", "-m", "a", "--peak-threshold", "-1e9", "--min-line-scores", "-1E+9",
     "--centroid-peak-threshold", "-inf", "--max-edge-length-ratio", "-.5"],
    ["-i", "x.mp4", "-m", "a", "--stream_mode", "download"],
]


@pytest.mark.parametrize("command", ["predict", "track", "infer"])
@pytest.mark.parametrize("line", range(len(PREDICT_LINES)))
def test_predict_kwargs_match(recorders, command, line):
    argv = [command] + PREDICT_LINES[line]
    with pytest.warns(DeprecationWarning) if command == "infer" else contextlib.nullcontext():
        got, want = _both(argv)
    assert got == want
    if want:  # --stream-to-file with tracking: a usage error in both
        assert (command, want) == ("track", 2) and "--stream-to-file" in argv
        return
    assert len(recorders.port_predict.calls) == len(recorders.jax_predict.calls) == 1
    (pa, pk), (ja, jk) = recorders.port_predict.calls[0], recorders.jax_predict.calls[0]
    assert pa == ja
    assert _norm_kwargs(pk) == _norm_kwargs(jk)


PREDICT_USAGE_ERRORS = [
    ["-i", "x.mp4", "-m", "a", "--stream-to-file", "s.slp", "-t"],
    ["-i", "x.mp4", "-m", "a", "--stream-to-file", "s.slp", "--no-empty-frames"],
    ["-i", "x.mp4", "-m", "a", "--stream-to-file", "s.slp", "--embed", "true"],
    ["-i", "x.mp4", "-m", "a", "--write-interval", "5"],
    ["-i", "x.mp4"],
    ["-i", "x.mp4", "-m", "a", "--headers", "notjson"],
    ["-i", "x.mp4", "-m", "a", "--headers", "[1]"],
    ["-i", "x.mp4", "-m", "a", "--embed", "maybe"],
    ["-m", "a"],
    ["-i", "x.mp4", "-m", "a", "--batch-size", "abc"],
    ["-i", "x.mp4", "-m", "a", "--device", "tpu9"],
    ["-i", "x.slp", "--mask-backend", "sam", "-m", "a"],
    ["-i", "x.mp4", "-m", "a", "--kf-node-indices", "a,b"],
    ["-i", "x.mp4", "-m", "a", "--merge-thresholds", "x"],
    ["-i", "x.mp4", "-m", "a", "--output-format", "csv"],
    ["-i", "x.mp4", "-m", "a", "--peak-thresh", "0.1"],
]


@pytest.mark.parametrize("line", range(len(PREDICT_USAGE_ERRORS)))
def test_predict_usage_errors_match(recorders, line):
    got, want = _both(["predict"] + PREDICT_USAGE_ERRORS[line])
    assert got == want == 2
    assert not recorders.port_predict.calls and not recorders.jax_predict.calls


@pytest.fixture
def config_files(tmp_path):
    d = cfg_dict(max_epochs=1)
    (tmp_path / "cfgs").mkdir()
    for path in (tmp_path / "cfg.yaml", tmp_path / "cfgs" / "named.yaml"):
        path.write_text(yaml.safe_dump(d))
    (tmp_path / "video.yaml").write_text(yaml.safe_dump(
        {"video_paths": ["v1.mp4"], "video_path_map": {"/a.mp4": "/b.mp4"},
         "prefix_map": {"/old": "/new"}}))
    return tmp_path


TRAIN_LINES = [
    ["{root}/cfg.yaml"],
    ["{root}/cfg.yaml", "trainer_config.max_epochs=3", "trainer_config.seed=11"],
    ["--config", "{root}/cfg.yaml", "-v", "a.mp4", "--video-paths", "b.mp4"],
    ["-c", "named", "-d", "{root}/cfgs", "-v", "d.mp4"],
    ["--config-name", "named.yaml", "--config-dir", "{root}/cfgs"],
    ["{root}/cfg.yaml", "--video-path-map", "old.mp4", "new.mp4", "--video-path-map", "x", "y",
     "--prefix-map", "/data", "/mnt"],
    ["{root}/cfg.yaml", "--video-config", "{root}/video.yaml"],
    ["{root}/cfg.yaml", "data_config.validation_fraction=0.5", "-v", "c.mp4"],
]
TRAIN_USAGE_ERRORS = [[], ["{root}/missing.yaml"], ["{root}/cfg.yaml", "notanoverride"],
                      ["-c", "missing", "-d", "{root}"], ["--config", "{root}/missing.yaml"],
                      ["{root}/cfg.yaml", "--video-path-map", "only-one"],
                      # Without the positional, an override is taken for it, by both.
                      ["-c", "named", "-d", "{root}/cfgs", "trainer_config.max_epochs=4"]]


@pytest.mark.parametrize("line", range(len(TRAIN_LINES)))
def test_train_config_matches(recorders, config_files, line):
    argv = ["train"] + [a.format(root=config_files) for a in TRAIN_LINES[line]]
    got, want = _both(argv)
    assert got == want == 0
    ((jcfg,), jk), ((pcfg,), pk) = recorders.jax_train.calls[0], recorders.port_train.calls[0]
    assert jk == {} and pk == {"device": "cuda"}  # trainer_accelerator auto: the card
    assert port_to_dict(pcfg) == jax_to_dict(jcfg)


@pytest.mark.parametrize("line", range(len(TRAIN_USAGE_ERRORS)))
def test_train_usage_errors_match(recorders, config_files, line):
    argv = ["train"] + [a.format(root=config_files) for a in TRAIN_USAGE_ERRORS[line]]
    got, want = _both(argv)
    assert got == want == 2
    assert not recorders.port_train.calls and not recorders.jax_train.calls


def _predictions(io, tracked=True):
    rng = np.random.default_rng(0)
    skel = io.Skeleton(["n0", "n1", "n2"], edges=[(0, 1), (1, 2)])
    video = FrameVideo(blob_frames(6, seed=1), "clip.avi")
    track = io.Track("t0")
    lfs = []
    for f in range(6):
        insts = [io.PredictedInstance(rng.uniform(5, 60, (3, 2)), skel, point_scores=rng.random(3),
                                      score=float(rng.random()), track=track if tracked else None)
                 for _ in range(2)]
        lfs.append(io.LabeledFrame(video, f, insts))
    return io.Labels(lfs, videos=[video], skeletons=[skel], tracks=[track] if tracked else [])


RETRACK_LINES = [
    ["track", "-i", "{preds}"],
    ["predict", "-i", "{preds}", "-t", "--max-tracks", "2", "--frames", "1-4",
     "--post-connect-single-breaks", "-n", "2", "-o", "{out}"],
    ["track", "-i", "{preds}", "--video-index", "0", "--use-kalman", "-n", "2",
     "--output-format", "slp", "--output-format", "analysis_h5", "-o", "{out}"],
]
RETRACK_USAGE_ERRORS = [
    ["track", "-i", "{preds}", "--filter-min-instance-score", "0.3"],
    ["track", "-i", "{preds}", "--only-suggested-frames"],
    ["track", "-i", "{preds}", "--video-index", "3"],
]


@pytest.mark.parametrize("line", range(len(RETRACK_LINES)))
def test_tracking_only_retrack_matches(recorders, tmp_path, line):
    preds = tmp_path / "preds.slp"
    _predictions(jio).save(str(preds))
    outs = {}
    for name in ("port", "jax"):
        argv = [a.format(preds=preds, out=tmp_path / f"{name}.slp")
                for a in RETRACK_LINES[line]]
        code = (pcli.main(argv) if name == "port" else CliRunner().invoke(jcli.cli, argv).exit_code)
        assert code == 0
        outs[name] = argv
    ((jl,), jk), ((pl,), pk) = recorders.jax_track.calls[0], recorders.port_track.calls[0]
    assert jk == pk
    assert [lf.frame_idx for lf in pl] == [lf.frame_idx for lf in jl]
    assert all(inst.track is None for lf in pl for inst in lf.instances)
    if "-o" not in RETRACK_LINES[line]:
        assert (tmp_path / "preds.predictions.slp").exists()
    else:
        got, want = load_slp(tmp_path / "port.slp"), jax_load_slp(str(tmp_path / "jax.slp"))
        assert len(got) == len(want)


@pytest.mark.parametrize("line", range(len(RETRACK_USAGE_ERRORS)))
def test_tracking_only_retrack_usage_errors_match(recorders, tmp_path, line):
    preds = tmp_path / "preds.slp"
    _predictions(jio).save(str(preds))
    argv = [a.format(preds=preds) for a in RETRACK_USAGE_ERRORS[line]]
    got, want = _both(argv)
    assert got == want == 2


TRACK_ONLY_LINES = [
    [],
    ["--window-size", "3", "--scoring-method", "iou", "--max-tracks", "2"],
    ["--target-instance-count", "2", "--pre-cull-to-target", "--pre-cull-iou-threshold", "0.4",
     "--post-connect-single-breaks", "--no-pre-cull-to-target"],
]


@pytest.mark.parametrize("line", range(len(TRACK_ONLY_LINES)))
def test_track_only_kwargs_match(recorders, tmp_path, line):
    preds = tmp_path / "preds.slp"
    _predictions(jio).save(str(preds))
    for name in ("port", "jax"):
        argv = ["track-only", "-i", str(preds), "-o", str(tmp_path / f"{name}.slp")] \
            + TRACK_ONLY_LINES[line]
        code = (pcli.main(argv) if name == "port" else CliRunner().invoke(jcli.cli, argv).exit_code)
        assert code == 0
    (_, jk), (_, pk) = recorders.jax_track.calls[0], recorders.port_track.calls[0]
    assert jk == pk
    got, want = load_slp(tmp_path / "port.slp"), jax_load_slp(str(tmp_path / "jax.slp"))
    # Each package records its own version under its own name.
    keys = {k.replace("sleap_nn_tpu_torch_", "sleap_nn_tpu_") for k in got.provenance}
    assert keys == set(want.provenance)
    for k in ("pipeline_type", "tracking_config", "frames_processed"):
        assert got.provenance[k] == want.provenance[k], k


EVAL_LINES = [
    [],
    ["--save-metrics", "m.npz", "--oks-stddev", "0.05", "--oks_scale", "2.5",
     "--match_threshold", "0.1", "--no-user-labels-only", "--match-method", "oks"],
    ["--user_labels_only", "--match_method", "centroid", "--anchor-part", "n0", "-s", "x.npz"],
]
METRICS = {"mOKS": {"mOKS": 0.5}, "voc_metrics": {"oks_voc.mAP": 0.25, "oks_voc.mAR": 0.125},
           "distance_metrics": {"avg": 1.123456789}, "pck_metrics": {"PCK@5": float("nan")},
           "detection_metrics": {"precision": 1.0, "recall": 0.5, "f1": 2 / 3, "other": 3}}


@pytest.mark.parametrize("metrics", [None, METRICS], ids=["none", "metrics"])
@pytest.mark.parametrize("line", range(len(EVAL_LINES)))
def test_eval_kwargs_and_summary_match(recorders, tmp_path, capsys, line, metrics):
    gt, pr = tmp_path / "gt.slp", tmp_path / "pr.slp"
    gt.touch()
    pr.touch()
    recorders.jax_eval.ret = recorders.port_eval.ret = metrics
    argv = ["eval", "-g", str(gt), "--predicted_path", str(pr)] + EVAL_LINES[line]
    want = CliRunner().invoke(jcli.cli, argv)
    capsys.readouterr()
    assert pcli.main(argv) == want.exit_code == 0
    assert capsys.readouterr().out == want.output
    assert recorders.port_eval.calls == recorders.jax_eval.calls


def pose_slp(path):
    """A one-frame pose ``.slp`` with its frame embedded."""
    from sleap_nn_tpu_torch.io.slp import save_slp

    skel = pio.Skeleton(["n0", "n1"])
    frames = blob_frames(1, seed=3)
    save_slp(path, pio.Labels([pio.LabeledFrame(FrameVideo(frames), 0, [
        pio.PredictedInstance.from_numpy(points=np.array([[8.0, 9.0], [20.0, 22.0]]),
                                         point_scores=np.ones(2), skeleton=skel, score=0.9)])],
        skeletons=[skel]), embed=True)
    return str(path)


def test_unported_commands_exit_naming_their_item(tmp_path, capsys):
    f = tmp_path / "x.slp"
    f.touch()
    # config and config-generate are ported (tests/test_torch_config_tooling.py);
    # export and sam are ported: the JAX package's export formats raise, and
    # sam's backend sam3 raises the JAX package's ImportError in both (the
    # workflow itself: tests/test_torch_sam_workflow.py).
    src = pose_slp(tmp_path / "poses.slp")
    for argv, item in ((["sam", "-i", src, "--mask-backend", "sam3"], "mask_backend='sam3'"),
                       (["export", str(tmp_path), "--format", "savedmodel"], "JAX package")):
        error = ImportError if argv[0] == "sam" else ValueError
        if argv[0] == "sam":
            want = CliRunner().invoke(jcli.cli, argv)
            assert isinstance(want.exception, error) and item in str(want.exception)
        with pytest.raises(error, match=item):
            pcli.main(argv)
    # Their usage errors are click's.
    assert pcli.main(["sam", "-i", str(f)]) == 2
    assert pcli.main(["export"]) == 2


def test_unported_knobs_reach_run_predict_and_raise(dirs, tmp_path):  # noqa: F811
    frames = blob_frames(4, seed=9)
    clip = write_clip(tmp_path / "clip.avi", frames)
    base = ["predict", "-i", clip, "-m", str(dirs["single_instance"].cond), "--device", "cpu",
            "-o", str(tmp_path / "o.slp")]
    for extra, match in ((["--runtime", "stablehlo"], "JAX package"),
                         (["--data-parallel"], None),
                         (["--profile-dir", str(tmp_path / "p")], None),
                         (["--stream-mode", "stream"], None)):
        # Ported: one replica on the CPU; a trace of the run; a stream mode
        # (a local clip is read in place whatever the mode).
        if match is None:
            (tmp_path / "o.slp").unlink(missing_ok=True)
            assert pcli.main(base + extra) == 0
            assert (tmp_path / "o.slp").exists()
            if "--profile-dir" in extra:
                assert len(list((tmp_path / "p").glob("*.pt.trace.json"))) == 1
            continue
        error = ValueError if "--runtime" in extra else NotImplementedError
        with pytest.raises(error, match=match):
            pcli.main(base + extra)
    # The segmentation knobs are ported: on a pose model they do nothing, as
    # in the JAX package.
    assert pcli.main(base + ["--mask-output", "polygon", "--fg-threshold", "0.7"]) == 0
    # --mask-backend reaches run.predict's SAM short-circuit: sam3 raises the
    # JAX package's ImportError in both.
    argv = ["predict", "-i", pose_slp(tmp_path / "poses.slp"), "--mask-backend", "sam3",
            "--device", "cpu"]
    want = CliRunner().invoke(jcli.cli, argv)
    assert isinstance(want.exception, ImportError) and "sam3" in str(want.exception)
    with pytest.raises(ImportError, match="mask_backend='sam3' requires"):
        pcli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        pcli.main(base[:-4] + ["-o", str(tmp_path / "o.slp")])  # no --device: the card


# -- end to end on the CPU ------------------------------------------------------------


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    root = tmp_path_factory.mktemp("media")
    frames = blob_frames(8, seed=9)
    return ns(root=root, frames=frames, avi=write_clip(root / "clip.avi", frames))


def _invoke_jax(argv):
    res = CliRunner().invoke(jcli.cli, [str(a) for a in argv])
    if res.exception is not None and not isinstance(res.exception, SystemExit):
        raise res.exception
    assert res.exit_code == 0, res.output
    return res.output


def _assert_same_predictions(got, want, atol):
    assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
    assert [t.name for t in got.tracks] == [t.name for t in want.tracks]
    n = 0
    for g, w in zip(got.labeled_frames, want.labeled_frames):
        assert len(g.instances) == len(w.instances), g.frame_idx
        for gi, wi in zip(g.instances, w.instances):
            np.testing.assert_array_equal(np.isnan(gi.points), np.isnan(wi.points))
            np.testing.assert_allclose(gi.points, wi.points, atol=atol, rtol=0)
            np.testing.assert_allclose(gi.point_scores, wi.point_scores, atol=1e-5, rtol=0)
            np.testing.assert_allclose(gi.score, wi.score, atol=1e-5, rtol=0)
            assert (gi.track and gi.track.name) == (wi.track and wi.track.name)
            n += 1
    return n


@pytest.mark.parametrize("type_set", ["topdown", "bottomup"])
def test_predict_track_only_and_eval_match_jax_end_to_end(dirs, media, tmp_path,  # noqa: F811
                                                          type_set, capsys):
    models = ([dirs["centroid"].cond, dirs["centered_instance"].cond] if type_set == "topdown"
              else [dirs["bottomup"].cond])
    argv = ["predict", "-i", media.avi, "--device", "cpu", "-b", "4"]
    for m in models:
        argv += ["-m", str(m)]
    if type_set == "bottomup":
        argv += ["--min-line-scores", "-0.5"]
    out = {}
    for name in ("port", "jax"):
        path = tmp_path / f"{name}.slp"
        if name == "port":
            assert pcli.main([str(a) for a in argv] + ["-o", str(path)]) == 0
        else:
            _invoke_jax(argv + ["-o", path])
        out[name] = path
    got, want = load_slp(out["port"]), load_slp(out["jax"])
    assert _assert_same_predictions(got, want, ATOL[type_set]) >= 8
    assert len(jax_load_slp(str(out["port"]))) == len(got)

    # track-only on each package's file, each by its own command.
    for name in ("port", "jax"):
        cmd = ["track-only", "-i", out[name], "-o", tmp_path / f"{name}.tracked.slp",
               "--max-tracks", "2"]
        if name == "port":
            assert pcli.main([str(a) for a in cmd]) == 0
        else:
            _invoke_jax(cmd)
    got = load_slp(tmp_path / "port.tracked.slp")
    want = load_slp(tmp_path / "jax.tracked.slp")
    assert len(got.tracks) == len(want.tracks) >= 1
    _assert_same_predictions(got, want, ATOL[type_set])

    # eval of the port's predictions against the labels they came from.
    gt = tmp_path / "gt.slp"
    gt_labels = _gt_labels(pio, media, got)
    gt_labels.save(str(gt))
    capsys.readouterr()
    summary = {}
    for name in ("port", "jax"):
        cmd = ["eval", "-g", gt, "-p", out["port"], "-s", tmp_path / f"{name}.npz"]
        if name == "port":
            assert pcli.main([str(a) for a in cmd]) == 0
            summary[name] = capsys.readouterr().out.strip().splitlines()[-1]
        else:
            summary[name] = _invoke_jax(cmd).strip().splitlines()[-1]
    assert json.loads(summary["port"]) == json.loads(summary["jax"])
    direct = pevaluation.run_evaluation(str(gt), str(out["port"]))
    assert json.loads(summary["port"]) == pcli.eval_summary(direct)


def _gt_labels(io, media, preds):
    """User labels at the predicted points, moved half a pixel, on the
    predicted frames."""
    skel = preds.skeletons[0]
    video = preds.videos[0]
    lfs = []
    for lf in preds.labeled_frames:
        insts = [io.Instance(inst.numpy() + 0.5, skel) for inst in lf.instances
                 if np.isfinite(inst.numpy()).all()]
        lfs.append(io.LabeledFrame(video, lf.frame_idx, insts))
    return io.Labels(lfs, videos=[video], skeletons=[skel])


@pytest.fixture(scope="module")
def trained(tmp_path_factory, media):
    """``train`` by both commands from one YAML whose labels the JAX
    package's ``save_slp`` wrote (an ``.slp`` referencing the MJPG clip)."""
    root = tmp_path_factory.mktemp("train")
    from tests.test_torch_train_files import _labels
    from sleap_nn_tpu.io import video as jvideo

    _labels(jio, jvideo.Video(media.avi), n=8).save(str(root / "train.slp"))
    d = cfg_dict(batch=2, max_epochs=1, train_steps_per_epoch=1, save_ckpt=True,
                 trainer_accelerator="cpu")
    d["data_config"]["train_labels_path"] = [str(root / "train.slp")]
    (root / "cfg.yaml").write_text(yaml.safe_dump(d))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # Post-training predictions at threshold -1e9 in both packages, so
        # that the briefly trained models emit predictions.
        for mod in (jtrain, ptrain):
            mp.setattr(mod, "_eval_split",
                       functools.partial(mod._eval_split, peak_threshold=-1e9))
        for name in ("port", "jax"):
            argv = ["train", root / "cfg.yaml", f"trainer_config.ckpt_dir={root / name}",
                    "trainer_config.run_name=run"]
            if name == "port":
                assert pcli.main([str(a) for a in argv]) == 0
            else:
                _invoke_jax(argv)
            out[name] = root / name / "run"
    return out


def test_train_writes_the_jax_model_dir(trained):
    pdir, jdir = trained["port"], trained["jax"]
    names = {p.name for p in pdir.iterdir()}
    assert names == {p.name for p in jdir.iterdir()}
    assert {"labels_train_gt_0.slp", "labels_val_gt_0.slp", "labels_pr.train_0.slp",
            "labels_pr.val_0.slp", "metrics.val.0.npz", "best.ckpt",
            "training_config.yaml"} <= names
    for split in ("train", "val"):
        got = load_slp(pdir / f"labels_{split}_gt_0.slp")
        want = jax_load_slp(str(jdir / f"labels_{split}_gt_0.slp"))
        assert [lf.frame_idx for lf in got] == [lf.frame_idx for lf in want]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
            np.testing.assert_array_equal(a.image, b.image)
    pcfg = yaml.safe_load((pdir / "training_config.yaml").read_text())
    jcfg = yaml.safe_load((jdir / "training_config.yaml").read_text())
    assert pcfg["data_config"]["train_labels_path"] == jcfg["data_config"]["train_labels_path"]


def _rich_sections(output):
    """(title, rows) of the JAX command's rich tables."""
    sections, title, rows = [], None, []
    for line in output.splitlines():
        s = line.strip()
        if all(0x2500 <= ord(c) <= 0x257F or c == " " for c in s):  # rules and borders
            continue
        if "│" in s or "┃" in s:
            cells = [c.strip() for c in s.replace("┃", "│").strip("│").split("│")]
            if title is not None and cells != ["File", "Size"]:
                rows.append(tuple(cells))
            continue
        if title is not None:
            sections.append((title, rows))
        title, rows = s, []
    if title is not None:
        sections.append((title, rows))
    return sections


def test_info_prints_the_jax_sections(trained, dirs, capsys, monkeypatch):  # noqa: F811
    monkeypatch.setenv("COLUMNS", "250")
    for model_dir in (trained["port"], dirs["bottomup"].trained):
        want = _rich_sections(_invoke_jax(["info", model_dir]))
        got = model_info_sections(model_dir)
        assert [t for t, _ in got] == [t for t, _ in want]
        assert got == want
        capsys.readouterr()
        assert pcli.main(["info", str(model_dir)]) == 0
        text = capsys.readouterr().out
        for title, rows in got:
            assert title in text
            for a, b in rows:
                assert a in text and b in text
    assert pcli.main(["info", str(trained["port"] / "nope")]) == 2  # click.Path(exists=True)
    empty = trained["port"].parent / "empty"
    empty.mkdir(exist_ok=True)
    assert pcli.main(["info", str(empty)]) == CliRunner().invoke(
        jcli.cli, ["info", str(empty)]).exit_code == 1


def test_system_runs_on_the_cpu(capsys):
    assert pcli.main(["system"]) == 0
    out = capsys.readouterr().out
    assert "sleap-nn-tpu-torch system report" in out
    assert "device smoke test: OK" in out
    assert "CPU only" in out and "torch:" in out and "nvcc:" in out and "g++:" in out


def test_python_m_predict_without_h5py(dirs, media, tmp_path):  # noqa: F811
    """``python -m sleap_nn_tpu_torch.cli predict`` with h5py blocked writes
    the ``.slp`` and the analysis file, and both read back."""
    out = tmp_path / "pred.slp"
    args = ["predict", "-i", media.avi, "-m", str(dirs["single_instance"].cond),
            "--device", "cpu", "-o", str(out), "--output-format", "slp",
            "--output-format", "analysis_h5"]
    code = ("import runpy, sys\n"
            "sys.modules['h5py'] = None\n"
            f"sys.argv = ['sleap-nn-tpu-torch'] + {args!r}\n"
            "runpy.run_module('sleap_nn_tpu_torch.cli', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Predicted 8 frames" in proc.stdout
    labels = load_slp(out)
    assert len(labels) == 8
    assert len(jax_load_slp(str(out))) == 8
    import h5py

    with h5py.File(tmp_path / "pred.analysis.h5", "r") as f:
        assert f["tracks"].shape[-1] == 8


def test_make_rolling_fps_matches_jax():
    clock = iter([0.0, 0.5, 1.0, 1.0, 3.0]).__next__
    clock2 = iter([0.0, 0.5, 1.0, 1.0, 3.0]).__next__
    got, want = pcli.make_rolling_fps(window=3, clock=clock), jcli.make_rolling_fps(
        window=3, clock=clock2)
    for n in (0, 4, 8, 8, 20):
        assert got(n) == want(n)


def test_frames_and_default_paths_match_jax():
    for s in (None, "", "0-10", "1,-20", "3,5,7", "4"):
        assert pcli._parse_frames(s) == jcli._parse_frames(s)
    for p in ("x.mp4", "/a/b/c.pkg.slp", "http://h/v.mp4?x=1", "rel/dir/v"):
        assert pcli._default_predictions_path(p) == jcli._default_predictions_path(p)
    kw = dict(copy.deepcopy({k: None for k in pcli._TRACKER_KNOBS}), tracking=False)
    assert pcli._build_tracker_kwargs(dict(kw)) == jcli._build_tracker_kwargs(dict(kw)) == {}
