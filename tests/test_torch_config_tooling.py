"""Port parity: the config tooling against the JAX package.

``config/get_config.py`` (the same YAML for a matrix of keyword
arguments), ``config/sample_configs.py`` (every sample equal to the
committed ``docs/sample_configs/*.yaml``, read only), ``config/docgen.py``
and ``cli_docgen.py`` (the JAX package's references but for their headers
and the port's listed differences), ``config_generator/`` (analysis,
recommendation, memory and architecture estimates, the generator: equal on
synthetic ``.slp`` files written here), the command line's ``config`` and
``config-generate`` (the JAX command's output and files), and the
interactive front end: the plain prompts and the curses screens, driven
through a fake screen, save the YAML the JAX package's front end saves for
the same keys. Nothing here writes under ``docs/``.

One deliberate difference: the throughput preset's ``note`` states no
frames/s figure (the JAX package's is a TPU measurement), so it is left out
of the comparisons that carry it.
"""

import curses
import dataclasses
import io
import json
import re
from pathlib import Path

import numpy as np
import pytest
import yaml
from click.testing import CliRunner

from sleap_nn_tpu import cli as jcli
from sleap_nn_tpu import cli_docgen as jcli_docgen
from sleap_nn_tpu import config_generator as jgen
from sleap_nn_tpu.config import get_config as jget
from sleap_nn_tpu.config import sample_configs as jsamples
from sleap_nn_tpu.config import to_yaml as jax_to_yaml
from sleap_nn_tpu.config.docgen import HEADER as JDOC_HEADER
from sleap_nn_tpu.config.docgen import generate_config_reference as jax_config_reference
from sleap_nn_tpu.config_generator import architecture_estimates as jarch
from sleap_nn_tpu.config_generator import tui as jtui
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu_torch import cli as pcli
from sleap_nn_tpu_torch import cli_docgen as pcli_docgen
from sleap_nn_tpu_torch import config_generator as pgen
from sleap_nn_tpu_torch.config import docgen as pdocgen
from sleap_nn_tpu_torch.config import get_config as pget
from sleap_nn_tpu_torch.config import sample_configs as psamples
from sleap_nn_tpu_torch.config.base import to_yaml
from sleap_nn_tpu_torch.config_generator import architecture_estimates as parch
from sleap_nn_tpu_torch.config_generator import tui as ptui
from tests.test_torch_model_dir import FrameVideo
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
SAMPLE_DIR = ROOT / "docs" / "sample_configs"


# -- synthetic datasets ----------------------------------------------------------


DATASETS = {
    # name: (height, width, channels, frames, node names, instances a frame,
    #        tracks, overlapping instances)
    "topdown": (96, 96, 1, 6, ["head", "thorax", "tail"], (1, 3), 0, False),
    "single_side": (80, 112, 3, 5, ["nose", "left_ear", "right_ear", "tail"], (1, 1), 0,
                    False),
    "crowded": (128, 128, 1, 6, ["a", "b", "c", "d"], (3, 4), 0, True),
    "tracked": (96, 96, 1, 6, ["a", "b", "c"], (2, 2), 2, False),
    "tracked_overlap": (96, 96, 1, 6, ["a", "b", "c"], (2, 2), 2, True),
    "one_node": (96, 96, 1, 5, ["centroid"], (2, 3), 0, False),
    "megapixel": (1024, 1024, 1, 2, ["a", "b", "c"], (2, 3), 0, False),
}


def write_dataset(path, name, seed=0):
    """A ``.pkg.slp`` with embedded frames, written by the JAX package."""
    h, w, c, n, nodes, (lo, hi), n_tracks, overlap = DATASETS[name]
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n, h, w, c), dtype=np.uint8)
    video = FrameVideo(frames, f"{name}.mp4")
    skel = jio.Skeleton(nodes, edges=[(i, i + 1) for i in range(len(nodes) - 1)])
    tracks = [jio.Track(f"id{i}") for i in range(n_tracks)]
    lfs = []
    for f in range(n):
        insts = []
        centre = rng.uniform(30, min(h, w) - 30, 2)
        for k in range(int(rng.integers(lo, hi + 1))):
            if not overlap:
                centre = rng.uniform(20, min(h, w) - 20, 2)
            pts = centre + rng.normal(0, 6, (len(nodes), 2))
            if k == 1 and len(nodes) > 2:
                pts[-1] = np.nan  # an invisible node
            insts.append(jio.Instance(pts, skel, track=tracks[k] if tracks else None))
        lfs.append(jio.LabeledFrame(video, f, insts))
    jio.Labels(lfs, videos=[video], skeletons=[skel], tracks=tracks).save(path, embed=True)
    return str(path)


@pytest.fixture(scope="module")
def slps(tmp_path_factory):
    root = tmp_path_factory.mktemp("slps")
    return {name: write_dataset(root / f"{name}.pkg.slp", name, seed=i)
            for i, name in enumerate(DATASETS)}


def _without_note(d):
    """A recommendation summary without the throughput preset's note."""
    d = json.loads(json.dumps(d))
    if isinstance(d.get("throughput_preset"), dict):
        d["throughput_preset"].pop("note", None)
    if isinstance(d.get("recommendation"), dict):
        d["recommendation"] = _without_note(d["recommendation"])
    return d


# -- get_config ----------------------------------------------------------------------


GET_CONFIG_CASES = [
    {},
    {"head_configs": "centroid", "backbone": "unet_medium_rf"},
    {"head_configs": "centered_instance", "backbone": "unet_large_rf", "crop_size": 160},
    {"head_configs": "bottomup", "backbone": "convnext_tiny", "batch_size": 2},
    {"head_configs": "multi_class_bottomup", "backbone": "swint_small", "max_epochs": 5},
    {"head_configs": "multi_class_topdown", "backbone": "unet", "filters": 16,
     "filters_rate": 2.0, "max_stride": 32},
    {"head_configs": "bottomup_segmentation", "backbone": "pretrained"},
    {"head_configs": "semantic_segmentation", "backbone": {"unet": {"filters": 8}}},
    {"head_configs": {"centroid": {"confmaps": {"sigma": 2.5, "anchor_part": "a"}}}},
    {"head_configs": "centered_instance", "backbone": "unet_medium_rf", "output_stride": 4,
     "crop_size": 128},
    {"train_labels_path": ["a.slp"], "val_labels_path": ["b.slp"], "scale": 0.5,
     "ensure_rgb": True, "max_height": 512, "max_width": 640, "validation_fraction": 0.2},
    {"intensity_aug": "brightness", "geometric_aug": ["rotation", "flip", "mixup"]},
    {"intensity_aug": ["uniform_noise", "contrast"], "geometric_aug": "translate"},
    {"intensity_aug": {"contrast_p": 0.3}, "geometric_aug": {"rotation_max": 90.0,
                                                               "affine_p": 0.4}},
    {"geometric_aug": "erase_scale", "use_same_data_for_val": True},
    {"learning_rate": 3e-4, "optimizer": "AdamW", "save_ckpt": True, "ckpt_dir": "runs",
     "run_name": "r", "seed": 7, "min_train_steps_per_epoch": 10},
    {"init_weights": "xavier", "backbone": "convnext", "model_type": "small"},
    {"backbone": "swint", "patch_size": 2},
]


@pytest.mark.parametrize("kwargs", GET_CONFIG_CASES)
def test_get_config_yaml_matches_jax(kwargs):
    assert to_yaml(pget.get_config(**kwargs)) == jax_to_yaml(jget.get_config(**kwargs))


@pytest.mark.parametrize("fn,arg", [
    ("get_backbone_config", "resnet"), ("get_backbone_config", {"vit": {}}),
    ("get_head_configs", "keypoints")])
def test_get_config_refuses_what_jax_refuses(fn, arg):
    for module in (pget, jget):
        with pytest.raises(ValueError, match="Unknown"):
            getattr(module, fn)(arg)


@pytest.mark.parametrize("intensity,geometric", [
    (None, None), ("gaussian_noise", None), (None, "scale"), (["brightness"], ["rotation"])])
def test_aug_config_matches_jax(intensity, geometric):
    got = pget.get_aug_config(intensity, geometric)
    want = jget.get_aug_config(intensity, geometric)
    assert (got is None) == (want is None)
    if got is not None:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


# -- sample configs, the config reference ------------------------------------------------


@pytest.mark.parametrize("name", sorted(psamples.SAMPLES))
def test_sample_configs_equal_the_committed_files(name):
    assert psamples.SAMPLES[name] == jsamples.SAMPLES[name]
    assert psamples.sample_yaml(name) == (SAMPLE_DIR / f"{name}.yaml").read_text()


def test_sample_configs_write_only_where_told(tmp_path):
    assert set(psamples.SAMPLES) == set(jsamples.SAMPLES)
    before = {p: p.stat().st_mtime_ns for p in SAMPLE_DIR.iterdir()}
    written = psamples.write_all(tmp_path / "out")
    assert {p.name for p in written.values()} == {p.name for p in before}
    for name, path in written.items():
        assert path.parent == tmp_path / "out"
        assert path.read_text() == (SAMPLE_DIR / path.name).read_text()
    assert psamples.main([]) == 2
    assert {p: p.stat().st_mtime_ns for p in SAMPLE_DIR.iterdir()} == before


def test_config_reference_matches_jax_but_its_header(tmp_path):
    got = pdocgen.generate_config_reference()
    want = jax_config_reference()
    assert got.startswith(pdocgen.HEADER) and want.startswith(JDOC_HEADER)
    assert got[len(pdocgen.HEADER):] == want[len(JDOC_HEADER):]
    assert "sleap_nn_tpu_torch/config/" in pdocgen.HEADER
    assert pdocgen.main([str(tmp_path / "ref.md")]) == 0
    assert (tmp_path / "ref.md").read_text() == got
    assert pdocgen.main([]) == 2


# -- the CLI reference ----------------------------------------------------------------


def _cli_tables(text, header):
    """command -> (hidden, first help line, arguments, {flags: (type, default)})."""
    out = {}
    for block in text[len(header):].split("\n## ")[1:]:
        lines = block.strip().splitlines()
        name = re.match(r"`([^`]+)`", lines[0]).group(1)
        args = next((ln for ln in lines if ln.startswith("Arguments: ")), None)
        rows = {}
        for ln in lines:
            if ln.startswith("| `"):
                cells = [c.strip() for c in ln.strip("|").split(" | ")]
                rows[cells[0]] = (cells[1], cells[2])
        out[name] = ("hidden alias" in lines[0], args, rows)
    return out


# The port's deliberate differences: its export writes torch.export
# programs (format "pt2" by default; JAX: "stablehlo"), and --runtime names
# "pt2" among its choices (its type and default are the JAX command's).
CLI_DIFFERENCES = {("export", "`--format`"): (("choice", "`'pt2'`"),
                                              ("choice", "`'stablehlo'`"))}


def test_cli_reference_matches_jax_but_the_listed_differences(tmp_path):
    got = _cli_tables(pcli_docgen.generate_cli_reference(), pcli_docgen.HEADER)
    want = _cli_tables(jcli_docgen.generate_cli_reference(), jcli_docgen.HEADER)
    assert list(got) == list(want)
    for name in want:
        g_hidden, g_args, g_rows = got[name]
        w_hidden, w_args, w_rows = want[name]
        assert (g_hidden, g_args, list(g_rows)) == (w_hidden, w_args, list(w_rows)), name
        for flags, row in w_rows.items():
            if (name, flags) in CLI_DIFFERENCES:
                assert (g_rows[flags], row) == CLI_DIFFERENCES[name, flags]
                continue
            assert g_rows[flags] == row, (name, flags)
    runtime = next(o for o in pcli.COMMANDS["predict"].params if getattr(o, "name", "") ==
                   "runtime")
    assert "pt2" in runtime.choices
    assert pcli_docgen.main([str(tmp_path / "cli.md")]) == 0
    assert (tmp_path / "cli.md").read_text() == pcli_docgen.generate_cli_reference()


# -- the config generator's engine ----------------------------------------------------------


@pytest.mark.parametrize("name", DATASETS)
def test_analysis_and_recommendation_match_jax(slps, name):
    got, want = pgen.analyze_slp(slps[name]), jgen.analyze_slp(slps[name])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.is_multi_instance, got.is_single_instance) == \
        (want.is_multi_instance, want.is_single_instance)
    g_rec, w_rec = pgen.recommend_config(got), jgen.recommend_config(want)
    assert _without_note(g_rec.summary()) == _without_note(w_rec.summary())
    for field in ("backbone_reason", "sigma_reason", "scale_reason", "batch_size_reason",
                  "rotation_reason"):
        assert getattr(g_rec, field) == getattr(w_rec, field)
    assert dataclasses.asdict(g_rec.pipeline) == dataclasses.asdict(w_rec.pipeline)
    if g_rec.throughput_preset is not None:
        assert "frames/s" not in g_rec.throughput_preset["note"]
        assert "TPU" not in g_rec.throughput_preset["note"]


STATS_CASES = [
    dict(max_instances_per_frame=1),
    dict(num_nodes=1, node_names=["c"]),
    dict(has_tracks=True, num_tracks=4, overlap_frequency=0.5),
    dict(has_tracks=True, num_tracks=4, overlap_frequency=0.1),
    dict(has_tracks=True, num_tracks=12, overlap_frequency=0.1),
    dict(overlap_frequency=0.4),
    dict(num_labeled_frames=6000, max_height=1024, max_width=1024),
    dict(max_height=2048, max_width=2048, avg_bbox_size=30.0),
    dict(avg_bbox_size=250.0, avg_bbox_diagonal=300.0, view_type="side"),
    dict(avg_bbox_size=0.0, avg_bbox_diagonal=0.0, view_type="unknown"),
]


def _stats(module, **over):
    base = dict(slp_path="x.slp", num_labeled_frames=100, num_videos=1, max_height=384,
                max_width=384, num_channels=1, max_instances_per_frame=2,
                avg_instances_per_frame=2.0, max_bbox_size=120.0, avg_bbox_size=100.0,
                avg_bbox_diagonal=140.0, num_nodes=5, node_names=list("abcde"),
                overlap_frequency=0.0, view_type="top")
    base.update(over)
    return module.DatasetStats(**base)


@pytest.mark.parametrize("over", STATS_CASES)
def test_recommendation_rules_match_jax(over):
    g = pgen.recommend_config(_stats(pgen, **over))
    w = jgen.recommend_config(_stats(jgen, **over))
    assert _without_note(g.summary()) == _without_note(w.summary())
    assert g.pipeline.reason == w.pipeline.reason


ESTIMATE_CASES = [
    dict(height=384, width=384),
    dict(height=1024, width=1024, channels=3, batch_size=8, filters=24, filters_rate=1.5,
         max_stride=32, output_stride=2, n_heads_channels=15, num_frames=100),
    dict(height=512, width=640, batch_size=2, filters=64, filters_rate=2.0, max_stride=64,
         output_stride=4, scale=0.5),
    dict(height=200, width=300, max_stride=8, output_stride=0),
]


@pytest.mark.parametrize("kw", ESTIMATE_CASES)
def test_memory_and_parameter_estimates_match_jax(kw):
    got, want = pgen.estimate_memory(**kw), jgen.estimate_memory(**kw)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.total_device_gb, got.total_gpu_gb, got.cache_memory_gb, str(got)) == \
        (want.total_device_gb, want.total_gpu_gb, want.cache_memory_gb, str(want))
    unet = {k: kw[k] for k in ("filters", "filters_rate", "max_stride", "output_stride")
            if k in kw}
    assert pgen.estimate_unet_params(**unet) == jgen.estimate_unet_params(**unet)


@pytest.mark.parametrize("fn,args", [
    ("compute_receptive_field", (8,)), ("compute_receptive_field", (128, 3, 5)),
    ("compute_max_stride_for_animal_size", (40.0,)),
    ("compute_max_stride_for_animal_size", (5000.0,)),
    ("recommend_default_max_stride", (30.0,)), ("recommend_default_max_stride", (80.0, 2.0)),
    ("recommend_default_max_stride", (150.0,)),
    ("compute_suggested_crop_size", (100.0, 16)),
    ("compute_suggested_crop_size", (100.0, 16, 45.0, 1.2, 160)),
    ("compute_pad_to_stride", (100, 130, 32)),
    ("compute_backbone_context_margin", (32,)),
    ("compute_suggested_tile_size", (40.0, 16, 2)),
    ("compute_suggested_tile_size", (500.0, 32, 4)),
    ("compute_suggested_tile_overlap", (40.0, 16)),
    ("compute_suggested_tile_overlap", (300.0, 32, 5.0, 256)),
    ("compute_augmentation_padding", (100.0, 30.0, 1.1)),
    ("decoder_blocks", (32, 0)), ("encoder_blocks", (64,)),
])
def test_architecture_estimates_match_jax(fn, args):
    assert getattr(parch, fn)(*args) == getattr(jarch, fn)(*args)


def test_receptive_field_refuses_what_jax_refuses():
    for module in (parch, jarch):
        with pytest.raises(ValueError, match="power of 2"):
            module.compute_receptive_field(12)


@pytest.mark.parametrize("name", DATASETS)
@pytest.mark.parametrize("preset", ["quality", "throughput"])
def test_generated_config_matches_jax(slps, name, preset, tmp_path):
    stats = pgen.analyze_slp(slps[name])
    if preset == "throughput" and pgen.recommend_config(stats).throughput_preset is None:
        for module in (pgen, jgen):
            with pytest.raises(ValueError, match="throughput preset"):
                module.generate_config(slps[name], preset=preset)
        return
    got = pgen.generate_config(slps[name], output_path=tmp_path / "p.yaml", preset=preset,
                               max_epochs=7)
    want = jgen.generate_config(slps[name], output_path=tmp_path / "j.yaml", preset=preset,
                                max_epochs=7)
    assert to_yaml(got) == jax_to_yaml(want)
    assert (tmp_path / "p.yaml").read_text() == (tmp_path / "j.yaml").read_text()


def test_generator_refuses_an_unknown_preset(slps):
    for module in (pgen, jgen):
        with pytest.raises(ValueError, match="Unknown preset"):
            module.generate_config(slps["topdown"], preset="fastest")


# -- the command line ----------------------------------------------------------------------


def _both(argv, capsys):
    """(port exit code, stdout, stderr), (JAX exit code, output)."""
    capsys.readouterr()
    code = pcli.main(argv)
    out = capsys.readouterr()
    want = CliRunner().invoke(jcli.cli, argv)
    return (code, out.out, out.err), (want.exit_code, want.output)


@pytest.mark.parametrize("extra", [[], ["--pipeline", "bottomup"],
                                   ["--pipeline", "single_instance", "--preset",
                                    "throughput"], ["--preset", "throughput"]])
@pytest.mark.parametrize("name", ["topdown", "crowded", "tracked"])
def test_config_auto_matches_jax(slps, name, extra, tmp_path, capsys):
    (p_code, p_out, _), (j_code, j_out) = _both(
        ["config", slps[name], "--auto", "--show-yaml"] + extra, capsys)
    assert p_code == j_code == 0 and p_out == j_out
    capsys.readouterr()
    p_code = pcli.main(["config", slps[name], "--auto", "-o", str(tmp_path / "p.yaml")] + extra)
    p_out = capsys.readouterr().out
    j_code = CliRunner().invoke(jcli.cli, ["config", slps[name], "--auto", "-o",
                                           str(tmp_path / "j.yaml")] + extra).exit_code
    assert p_code == j_code == 0
    assert (tmp_path / "p.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    assert p_out.splitlines()[-1] == f"Saved config to: {tmp_path / 'p.yaml'}"
    assert ("Throughput preset:" in p_out) == ("--preset" in extra)


def test_config_validates_and_echoes_a_yaml_with_overrides(slps, tmp_path, capsys):
    path = tmp_path / "c.yaml"
    pgen.generate_config(slps["topdown"], output_path=path)
    argv = ["config", str(path), "trainer_config.max_epochs=3",
            "model_config.backbone_config.unet.filters=16"]
    (p_code, p_out, _), (j_code, j_out) = _both(argv, capsys)
    assert p_code == j_code == 0 and p_out == j_out
    assert yaml.safe_load(p_out)["trainer_config"]["max_epochs"] == 3
    # A malformed override is a usage error in both.
    (p_code, _, p_err), (j_code, _) = _both(["config", str(path), "nokeyvalue"], capsys)
    assert p_code == j_code == 2 and "key=value" in p_err


@pytest.mark.parametrize("preset", ["quality", "throughput"])
@pytest.mark.parametrize("name", ["topdown", "single_side", "one_node"])
def test_config_generate_matches_jax(slps, name, preset, tmp_path, capsys):
    argv = ["config-generate", slps[name], "--max-epochs", "9", "--preset", preset]
    capsys.readouterr()
    assert pcli.main(argv + ["-o", str(tmp_path / "p.yaml")]) == 0
    got = json.loads(capsys.readouterr().out)
    run = CliRunner().invoke(jcli.cli, argv + ["-o", str(tmp_path / "j.yaml")])
    assert run.exit_code == 0
    want = json.loads(run.output)
    assert got.pop("output") == str(tmp_path / "p.yaml")
    assert want.pop("output") == str(tmp_path / "j.yaml")
    assert _without_note(got) == _without_note(want)
    assert (tmp_path / "p.yaml").read_text() == (tmp_path / "j.yaml").read_text()


def test_config_usage_errors_match_jax(slps, capsys):
    for argv in (["config", "--auto"],
                 ["config-generate", slps["topdown"], "--preset", "nope"]):
        (p_code, _, _), (j_code, _) = _both(argv, capsys)
        assert p_code == j_code == 2


# -- the interactive front end -----------------------------------------------------------


def _prompt_names(module, slp, pipeline, backbone):
    """The order the plain prompts ask in: the model fields, then the
    chosen pipeline's sections."""
    gen = pgen if module is ptui else jgen
    stats = gen.analyze_slp(slp)
    rec = gen.recommend_config(stats)
    names = [f.name for f in module._model_fields(rec)]
    for sec in module._config_sections(module._config_fields(slp, stats, rec),
                                       pipeline=pipeline, backbone=backbone):
        names.extend(f.name for f in sec.fields)
    return names


def _answers(module, slp, by_name, pipeline="topdown", backbone="unet", confirm=""):
    lines = []
    for name in _prompt_names(module, slp, pipeline, backbone):
        v = by_name.get(name, "")
        lines.extend(v if isinstance(v, list) else [v])
    return "\n".join(str(x) for x in lines + [confirm]) + "\n"


PROMPT_CASES = [
    ({}, "topdown", "unet", ""),
    ({"pipeline": "bottomup", "sigma": "3.5", "scale": "0.5", "output_stride": "4",
      "max_stride": "32", "filters": "16", "filters_rate": "2.0", "pafs_output_stride": "8",
      "batch_size": "8", "max_epochs": "50", "learning_rate": "0.0003", "rotation": "90",
      "augmentation": "off"}, "bottomup", "unet", ""),
    ({"sigma": ["-2", "4.0"], "max_stride": ["33", "64"], "crop_size": "192",
      "affine_p": "0.7", "tiling": "on", "tile_size": "256", "tile_overlap": "32",
      "validation_fraction": "0.2"}, "topdown", "unet", ""),
    ({"optimizer": "adamw", "scheduler": "cosine_warmup", "early_stop_patience": "5",
      "seed": "1234", "run_name": "tui_run", "save_ckpt": "on", "ohkm": "on",
      "ohkm_ratio": "3.0", "rotation_p": "0.9", "translate_p": "0.25",
      "translate_frac": "0.1", "noise_p": "0.3", "noise_std": "0.05", "contrast_p": "0.4",
      "brightness_p": "0.2", "anchor_part": "thorax"}, "topdown", "unet", "y"),
    ({"backbone": "convnext", "variant": "small", "scheduler": "reduce_on_plateau",
      "early_stop_patience": "0", "pipeline": "single_instance", "grayscale": "off"},
     "single_instance", "convnext", ""),
    ({"scheduler": "linear_warmup_decay", "pipeline": "nonsense"}, "topdown", "unet", "n"),
]


@pytest.mark.parametrize("case", range(len(PROMPT_CASES)))
def test_prompt_flow_saves_the_jax_yaml(slps, case, tmp_path, monkeypatch, capsys):
    by_name, pipeline, backbone, confirm = PROMPT_CASES[case]
    slp = slps["topdown"]
    saved = []
    for module, tag in ((ptui, "p"), (jtui, "j")):
        answers = _answers(module, slp, {**by_name, "output": str(tmp_path / f"{tag}.yaml")},
                           pipeline, backbone, confirm)
        monkeypatch.setattr("sys.stdin", io.StringIO(answers))
        saved.append(module.launch_tui(slp))
        printed = capsys.readouterr().out
        if tag == "p":
            p_printed = printed
    if confirm == "n":
        assert saved == [None, None] and not list(tmp_path.iterdir())
        return
    assert saved == [str(tmp_path / "p.yaml"), str(tmp_path / "j.yaml")]
    assert (tmp_path / "p.yaml").read_text() == (tmp_path / "j.yaml").read_text()
    assert "sleap-nn-tpu-torch config" in p_printed and "memory [" in p_printed
    if case == 2:  # the validation messages, then the values asked again
        assert "must be in (0, 50]" in p_printed and "power of 2" in p_printed


def test_memory_gauge_budget_is_the_card(slps, monkeypatch):
    stats = pgen.analyze_slp(slps["topdown"])
    rec = pgen.recommend_config(stats)
    mf, cf = ptui._model_fields(rec), ptui._config_fields(slps["topdown"], stats, rec)
    small = ptui._memory_gauge(stats, mf, cf)
    assert "/80 GB" in small
    next(f for f in cf if f.name == "batch_size").value = 512
    big = ptui._memory_gauge(stats, mf, cf)

    def total(g):
        return float(g.split("] ")[1].split("/")[0])

    assert total(big) > total(small)
    # The same estimate as the JAX front end's gauge, against its own budget.
    jmf, jcf = jtui._model_fields(rec), jtui._config_fields(slps["topdown"], stats, rec)
    next(f for f in jcf if f.name == "batch_size").value = 512
    assert total(jtui._memory_gauge(stats, jmf, jcf)) == total(big)


class FakeScreen:
    """What the curses front end draws on: keys from a script, text entry
    from a list of strings; each refresh keeps the drawn rows."""

    def __init__(self, keys, strings=(), size=(40, 120)):
        self.keys = [ord(k) if isinstance(k, str) else k for k in keys]
        self.strings = list(strings)
        self.size = size
        self.rows = {}
        self.frames = []

    def getmaxyx(self):
        return self.size

    def addstr(self, y, x, s, attr=0):
        if not (0 <= y < self.size[0] and x < self.size[1]):
            raise curses.error("outside the screen")
        self.rows[y] = self.rows.get(y, "")[:x].ljust(x) + s

    def erase(self):
        self.rows = {}

    def refresh(self):
        self.frames.append("\n".join(self.rows[y] for y in sorted(self.rows)))

    def redrawwin(self):
        pass

    def getch(self):
        if not self.keys:
            raise AssertionError("the script ran out of keys")
        return self.keys.pop(0)

    def getstr(self, y, x):
        return self.strings.pop(0).encode()


@pytest.fixture
def no_terminal(monkeypatch):
    for name in ("curs_set", "echo", "noecho"):
        monkeypatch.setattr(curses, name, lambda *a: None)


def _entries(module, slp, expanded=()):
    gen = pgen if module is ptui else jgen
    stats = gen.analyze_slp(slp)
    rec = gen.recommend_config(stats)
    names = []
    for sec in module._config_sections(module._config_fields(slp, stats, rec)):
        names.append(f"hdr:{sec.title}")
        if not sec.collapsed or sec.title in expanded:
            names.extend(f.name for f in sec.fields)
    return names


def _journey(module, slp, out_dir):
    """load -> model select -> configure (collapse and expand a section, a
    slider step, an edit, the trainer section, the file browser) ->
    confirm -> save."""
    e = _entries(module, slp, expanded=("trainer",))
    keys = ["n", "n", "\n", 12, "\n", curses.KEY_DOWN, curses.KEY_RIGHT]
    keys += [curses.KEY_DOWN] * (e.index("batch_size") - e.index("sigma")) + ["e"]
    keys += [curses.KEY_DOWN] * (e.index("hdr:trainer") - e.index("batch_size")) + ["\n"]
    keys += [curses.KEY_DOWN, curses.KEY_RIGHT]  # optimizer: adam -> adamw
    keys += [curses.KEY_DOWN] * (e.index("seed") - e.index("optimizer")) + ["e"]
    keys += [curses.KEY_DOWN] * (e.index("output") - e.index("seed")) + ["e", "f", "n"]
    keys += ["n", "b", "n", "s"]
    strings = ["64", "4321", str(out_dir / "placeholder.yaml"), "from_browser.yaml"]
    screen = FakeScreen(keys, strings)
    gen = pgen if module is ptui else jgen
    stats = gen.analyze_slp(slp)
    return module._curses_flow(screen, slp, stats, gen.recommend_config(stats)), screen


def test_curses_journey_saves_the_jax_yaml(slps, tmp_path, no_terminal):
    slp = slps["topdown"]
    (tmp_path / "p").mkdir()
    (tmp_path / "j").mkdir()
    got, screen = _journey(ptui, slp, tmp_path / "p")
    want, _ = _journey(jtui, slp, tmp_path / "j")
    assert got == str(tmp_path / "p" / "from_browser.yaml")
    assert want == str(tmp_path / "j" / "from_browser.yaml")
    assert Path(got).read_text() == Path(want).read_text()
    cfg = yaml.safe_load(Path(got).read_text())
    assert cfg["trainer_config"]["train_data_loader"]["batch_size"] == 64
    assert cfg["trainer_config"]["optimizer_name"] == "adamw"
    assert cfg["trainer_config"]["seed"] == 4321
    frames = screen.frames
    assert any("[load]" in f for f in frames) and any("[browse]" in f for f in frames)
    assert any("[+] targets" in f for f in frames) and any("[-] trainer" in f for f in frames)
    assert any("[confirm]" in f and "memory [" in f for f in frames)
    assert any("sleap-nn-tpu-torch config" in f for f in frames)


def test_curses_edit_errors_quit_and_small_screens(slps, no_terminal):
    slp = slps["topdown"]
    stats = pgen.analyze_slp(slp)
    rec = pgen.recommend_config(stats)
    screen = FakeScreen(["n", "n", curses.KEY_DOWN, "e", "e", "e", 12, "q"],
                        ["abc", "99", "3.25"])
    assert ptui._curses_flow(screen, slp, stats, rec) is None
    text = "\n".join(screen.frames)
    assert "not a valid float" in text and "must be in (0, 50]" in text
    assert "3.25" in screen.frames[-1]
    # Quit on the first screen; a screen smaller than the form.
    assert ptui._curses_flow(FakeScreen(["q"]), slp, stats, rec) is None
    tiny = FakeScreen(["n", "n", curses.KEY_DOWN, curses.KEY_RIGHT, "q"], size=(8, 40))
    assert ptui._curses_flow(tiny, slp, stats, rec) is None
    assert all(len(f.splitlines()) <= 8 for f in tiny.frames)


def test_curses_front_end_needs_a_terminal(slps, monkeypatch, capsys):
    """A terminal opens the curses screens (``curses.wrapper``); a missing
    path is refused as in JAX."""
    called = []
    monkeypatch.setattr("sys.stdin.isatty", lambda: True, raising=False)
    monkeypatch.setattr("sys.stdout.isatty", lambda: True, raising=False)
    monkeypatch.setattr(curses, "wrapper", lambda fn, *a: called.append(fn) or "x.yaml")
    assert ptui.launch_tui(slps["topdown"]) == "x.yaml"
    assert called == [ptui._curses_flow] and "Saved config to: x.yaml" in capsys.readouterr().out
    for module in (ptui, jtui):
        with pytest.raises(SystemExit, match="SLP_PATH is required"):
            module.launch_tui(None)


def test_field_sliders_and_sections_match_jax(slps):
    for module in (ptui, jtui):
        f = module._Field("sigma", 9.9, caster=float, slider=(0.5, 10.0, 0.25))
        f.cycle(+1)
        assert f.value == 10.0
        f.cycle(-1)
        assert f.value == 9.75
        i = module._Field("batch_size", 4, caster=int,
                          validate=lambda v: None if v >= 1 else "must be >= 1")
        assert not i.set_text("zero") and "int" in i.error
        assert not i.set_text("0") and i.error == "must be >= 1"
        assert i.set_text("8") and i.value == 8 and i.error is None
    stats = pgen.analyze_slp(slps["crowded"])
    rec = pgen.recommend_config(stats)
    for pipeline in ptui.PIPELINES:
        for backbone in ptui.BACKBONES:
            got = ptui._config_sections(ptui._config_fields(slps["crowded"], stats, rec),
                                        pipeline, backbone)
            want = jtui._config_sections(jtui._config_fields(slps["crowded"], stats, rec),
                                         pipeline, backbone)
            assert [(s.title, s.collapsed, [f.name for f in s.fields]) for s in got] == \
                [(s.title, s.collapsed, [f.name for f in s.fields]) for s in want]


def test_yaml_preview_is_the_saved_yaml(slps, tmp_path):
    """The confirm screen's preview: the first lines of the YAML that
    saving writes, as in the JAX front end."""
    slp = slps["tracked"]
    stats = pgen.analyze_slp(slp)
    rec = pgen.recommend_config(stats)
    previews = []
    for module in (ptui, jtui):
        mf, cf = module._model_fields(rec), module._config_fields(slp, stats, rec)
        previews.append(module._yaml_preview(slp, stats, rec, mf, cf))
        out = next(f for f in cf if f.name == "output")
        out.value = str(tmp_path / f"{module.__name__}.yaml")
        saved = Path(module._apply_and_save(slp, stats, rec, mf, cf)).read_text().splitlines()
        assert previews[-1][:-1] == saved[:len(previews[-1]) - 1] and previews[-1][-1] == "..."
    assert previews[0] == previews[1]
