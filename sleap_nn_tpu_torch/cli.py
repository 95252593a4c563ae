"""Command-line interface of the port: ``sleap-nn-tpu-torch`` (or
``python -m sleap_nn_tpu_torch.cli``).

Port of ``sleap_nn_tpu/cli.py``, built on argparse (click and rich are not
on the port's import list). It carries the JAX command's command names,
option strings (dashed and underscored aliases, short flags), defaults,
repeatable and multi-value options, help text and exit codes (2 for a
usage error): ``train``, ``predict`` (and the hidden ``infer``),
``track``, ``track-only``, ``eval``, ``system`` and ``info`` run the
port's ``train.run_training``, ``inference.run.predict``,
``tracking.run_tracker`` and ``evaluation.run_evaluation``. ``--device``
takes ``auto|cuda|cpu`` where JAX takes ``auto|tpu|cpu``: unset and
``auto`` mean the card (and raise without one); only ``cpu`` runs on the
CPU. ``config`` and ``config-generate`` run the port's config generator
(``config_generator/``), ``export`` the port's exporter and ``sam`` (and
``predict --mask-backend``) the port's SAM prompted masks
(``inference/sam``), on the card. Knobs of features the port lacks reach
``run.predict``, which refuses them. The
interactive progress is one rewritten stderr line with a rolling
frames/s.
"""

from __future__ import annotations

import argparse
import json
import logging
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PROG = "sleap-nn-tpu-torch"
VERSION = "0.1.0"


class UsageError(Exception):
    """A usage error: its message on stderr, exit code 2 (click's
    ``UsageError``)."""


class Opt:
    """One option, declared as click declares it: option strings (a
    ``--x/--no-x`` string is a boolean pair), an optional destination name
    (else derived from the first long option), and click's keywords."""

    def __init__(self, *decls: str, default=None, type: Optional[Callable] = None,
                 choices: Optional[Sequence[str]] = None, case_sensitive: bool = True,
                 multiple: bool = False, nargs: int = 1, is_flag: bool = False,
                 hidden: bool = False, help: Optional[str] = None,
                 metavar: Optional[str] = None, required: bool = False,
                 show_default: bool = False, exists: bool = False):
        self.opts: List[str] = []
        self.secondary_opts: List[str] = []
        name = None
        for d in decls:
            if not d.startswith("-"):
                name = d
            elif "/" in d:
                first, second = d.split("/", 1)
                self.opts.append(first)
                self.secondary_opts.append(second)
            else:
                self.opts.append(d)
        if name is None:
            longs = [o for o in self.opts if o.startswith("--")]
            name = (longs or self.opts)[0].lstrip("-").replace("-", "_").lower()
        self.name = name
        self.is_flag = is_flag or bool(self.secondary_opts)
        if self.is_flag and not self.secondary_opts and default is None:
            default = False
        if multiple and default is None:
            default = ()
        self.default = default
        self.multiple = multiple
        self.nargs = nargs
        self.choices = list(choices) if choices is not None else None
        self.case_sensitive = case_sensitive
        self.hidden = hidden
        self.help = help or ""
        self.metavar = metavar
        self.required = required
        self.show_default = show_default
        self.exists = exists
        if type is None and not self.is_flag and self.choices is None:
            if isinstance(default, bool):
                type = None
            elif isinstance(default, int):
                type = int
            elif isinstance(default, float):
                type = float
        self.type = type

    def convert(self, value: str):
        if self.choices is not None:
            if self.case_sensitive:
                return value
            for c in self.choices:
                if c.lower() == value.lower():
                    return c
            return value
        return self.type(value) if self.type is not None else value

    def add_to(self, parser: argparse.ArgumentParser):
        help_ = argparse.SUPPRESS if self.hidden else self.help
        if self.show_default and not self.hidden:
            help_ = f"{help_}  [default: {self.default}]".strip()
        if self.secondary_opts:
            parser.add_argument(*self.opts, dest=self.name, action="store_const", const=True,
                                help=help_)
            parser.add_argument(*self.secondary_opts, dest=self.name, action="store_const",
                                const=False, help=argparse.SUPPRESS)
            parser.set_defaults(**{self.name: self.default})
        elif self.is_flag:
            parser.add_argument(*self.opts, dest=self.name, action="store_true",
                                default=self.default, help=help_)
        else:
            kw = dict(dest=self.name, default=None if self.multiple else self.default,
                      required=self.required, help=help_, type=self.convert)
            if self.metavar:
                kw["metavar"] = tuple(self.metavar.split()) if self.nargs > 1 else self.metavar
            if self.nargs != 1:
                kw["nargs"] = self.nargs
            if self.multiple:
                kw["action"] = "append"
            if self.choices is not None:
                kw["choices"] = self.choices
            parser.add_argument(*self.opts, **kw)

    def finish(self, value):
        if self.multiple:
            value = tuple(tuple(v) if isinstance(v, list) else v for v in (value or ()))
        elif isinstance(value, list):
            value = tuple(value)
        return value


class Arg:
    """One positional argument (``nargs=-1``: any number)."""

    def __init__(self, name: str, required: bool = True, nargs: int = 1, exists: bool = False):
        self.name = name
        self.required = required
        self.nargs = nargs
        self.exists = exists

    def add_to(self, parser: argparse.ArgumentParser):
        if self.nargs == -1:
            nargs = "+" if self.required else "*"
        else:
            nargs = None if self.required else "?"
        parser.add_argument(self.name, nargs=nargs, metavar=self.name.upper())

    def finish(self, value):
        return tuple(value) if isinstance(value, list) else value


class Command:
    def __init__(self, name: str, fn: Callable, params: List, help: str, hidden: bool = False):
        self.name = name
        self.fn = fn
        self.params = params
        self.help = help
        self.hidden = hidden

    def parser(self) -> argparse.ArgumentParser:
        p = argparse.ArgumentParser(prog=f"{PROG} {self.name}", description=self.help,
                                    allow_abbrev=False)
        for prm in self.params:
            prm.add_to(p)
        return p

    def _joined(self, argv: List[str]) -> List[str]:
        """Click gives an option that takes one value the next argument,
        whatever it looks like; argparse would read ``-1e9`` or ``-inf`` as
        options. Such pairs are joined as ``--opt=value`` first."""
        takes = {o for prm in self.params if isinstance(prm, Opt)
                 and not prm.is_flag and prm.nargs == 1 for o in prm.opts}
        out, i = [], 0
        while i < len(argv):
            if argv[i] in takes and i + 1 < len(argv):
                out.append(f"{argv[i]}={argv[i + 1]}")
                i += 2
            else:
                out.append(argv[i])
                i += 1
        return out

    def parse(self, argv: List[str]) -> Dict:
        ns = vars(self.parser().parse_intermixed_args(self._joined(argv)))
        out = {}
        for prm in self.params:
            value = prm.finish(ns.get(prm.name))
            if prm.exists and value is not None:
                for v in (value if isinstance(value, tuple) else (value,)):
                    if not Path(v).exists():
                        label = prm.name.upper() if isinstance(prm, Arg) else "/".join(prm.opts)
                        raise UsageError(f"Invalid value for {label!r}: Path {v!r} does not exist.")
            out[prm.name] = value
        return out


COMMANDS: Dict[str, Command] = {}


def command(name: str, params: List, hidden: bool = False):
    """Register ``fn`` as the command ``name``; its docstring is the help."""
    def wrap(fn):
        COMMANDS[name] = Command(name, fn, params, (fn.__doc__ or "").strip(), hidden)
        return fn
    return wrap


def _setup_logging():
    """Surface the library's run lines (filter confirmations, the run
    summary) on stderr at INFO when the embedding program has not set up
    logging itself."""
    lib_logger = logging.getLogger("sleap_nn_tpu_torch")
    if not lib_logger.handlers and not logging.getLogger().handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter("%(levelname)s %(message)s"))
        lib_logger.addHandler(handler)
        lib_logger.setLevel(logging.INFO)


def echo(msg: str = "", err: bool = False):
    print(msg, file=sys.stderr if err else sys.stdout, flush=True)


def make_rolling_fps(window: int = 32, clock=None):
    """Windowed frames/s formatter for the progress line: the rate over a
    trailing window of ``(time, processed_frames)`` samples, so it follows
    the current throughput, not the lifetime mean. Returns
    ``fps_of(n_done) -> str`` ('' until two samples with a positive time
    delta exist). ``clock`` is injectable for tests."""
    import time as _time
    from collections import deque

    clock = clock or _time.perf_counter
    samples = deque(maxlen=window)

    def fps_of(n_done: int) -> str:
        samples.append((clock(), n_done))
        if len(samples) >= 2:
            (t0, n0), (t1, n1) = samples[0], samples[-1]
            if t1 > t0:
                return f"{(n1 - n0) / (t1 - t0):.1f} fps"
        return ""

    return fps_of


def _parse_overrides(pairs: Tuple[str, ...]) -> dict:
    out = {}
    for pair in pairs:
        if "=" not in pair:
            raise UsageError(f"Override must be key=value, got: {pair}")
        k, v = pair.split("=", 1)
        out[k] = v
    return out


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------


@command("train", [
    Arg("config_path", required=False, exists=True),
    Opt("--config", "config_opt", default=None,
        help="Path to the config YAML (alternative to the positional)."),
    Opt("--config-name", "-c", "config_name", default=None,
        help="Configuration file name (legacy hydra-style)."),
    Opt("--config-dir", "-d", "config_dir", default=".", show_default=True,
        help="Configuration directory (legacy hydra-style)."),
    Opt("--video-paths", "-v", "video_paths", multiple=True,
        help="Replace the labels file's video paths in order; repeatable."),
    Opt("--video-path-map", "video_path_map", nargs=2, multiple=True, metavar="OLD NEW",
        help="Map one old video path to a new path; repeatable."),
    Opt("--prefix-map", "prefix_map", nargs=2, multiple=True, metavar="OLD NEW",
        help="Map an old path prefix to a new prefix for ALL videos; repeatable."),
    Opt("--video-config", "video_config", default=None, hidden=True,
        help="YAML with video_paths/video_path_map/prefix_map "
             "(internal use for multi-process launches)."),
    Arg("overrides", required=False, nargs=-1),
])
def train(config_path, config_opt, config_name, config_dir, video_paths,
          video_path_map, prefix_map, video_config, overrides):
    """Train a model from a config YAML (dotted OVERRIDES like a.b.c=value)."""
    from sleap_nn_tpu_torch import train as train_mod
    from sleap_nn_tpu_torch.config import TrainingJobConfig

    if config_path is None:
        if config_opt is not None:
            config_path = config_opt
        elif config_name is not None:
            name = config_name if config_name.endswith((".yaml", ".yml", ".json")) \
                else config_name + ".yaml"
            config_path = str(Path(config_dir) / name)
        else:
            raise UsageError(
                "Provide a config: positional CONFIG_PATH, --config, or "
                "--config-dir/--config-name."
            )
    if not Path(config_path).exists():
        raise UsageError(f"Config not found: {config_path}")

    cfg = TrainingJobConfig.load_yaml(config_path, overrides=_parse_overrides(overrides))
    if video_config:
        import yaml

        with open(video_config) as f:
            vc = yaml.safe_load(f) or {}
        video_paths = video_paths or tuple(vc.get("video_paths", ()))
        video_path_map = video_path_map or tuple(
            (k, v) for k, v in (vc.get("video_path_map") or {}).items()
        )
        prefix_map = prefix_map or tuple(
            (k, v) for k, v in (vc.get("prefix_map") or {}).items()
        )
    if video_paths or video_path_map or prefix_map:
        cfg.data_config.video_paths = list(video_paths)
        cfg.data_config.video_path_map = dict(video_path_map)
        cfg.data_config.video_prefix_map = dict(prefix_map)
    # The JAX trainer's switch to its CPU backend picks the port's device.
    accel = (cfg.trainer_config.trainer_accelerator or "auto").lower()
    trainer = train_mod.run_training(cfg, device="cpu" if accel == "cpu" else "cuda")
    if trainer.ckpt_dir:
        echo(f"Model saved to: {trainer.ckpt_dir}")


# ---------------------------------------------------------------------------
# predict / infer / track
# ---------------------------------------------------------------------------


def _comma_floats(value: str) -> Tuple[float, ...]:
    """Comma-separated float list, e.g. '0.85,0.6,0.4'."""
    try:
        return tuple(float(v) for v in str(value).split(","))
    except ValueError:
        raise argparse.ArgumentTypeError(f"{value!r} is not a comma-separated float list")


_comma_floats.param_name = "floats"  # click's name of the JAX command's type


def _int_list(value: str) -> List[int]:
    """'1,3,5' -> [1, 3, 5]."""
    try:
        return [int(v) for v in str(value).split(",") if v != ""]
    except ValueError:
        raise argparse.ArgumentTypeError(f"{value!r} is not a comma-separated int list")


O = Opt

INFERENCE_OPTIONS = [
        # -- input / output ----------------------------------------------------
        O("--data-path", "--data_path", "-i", "data_path", required=True,
            help="Video or .slp path."),
        O("--headers", default=None,
            help="JSON HTTP headers for a remote --data-path URL "
                 "(e.g. '{\"Authorization\": \"Bearer ...\"}'; "
                 "ignored for local inputs)."),
        O("--stream-mode", "--stream_mode", "stream_mode", default=None,
            choices=["download", "stream"],
            help="Remote read strategy for a --data-path URL; "
                 "'stream' falls back to download-first in this "
                 "build (ignored for local inputs)."),
        O("--model-paths", "--model_paths", "-m", "model_paths",
            multiple=True,
            help="Model dir(s); pass twice for topdown (centroid + "
                 "centered_instance). Omit only with --mask-backend."),
        O("--output-path", "--output_path", "-o", "output_path",
            default=None, help="Output .slp path."),
        O("--output-format", "--output_format", "output_format",
            multiple=True, choices=["slp", "analysis_h5"],
            help="Repeatable; default slp. analysis_h5 writes one "
                 "SLEAP Analysis HDF5 per video."),
        O("--embed", choices=["auto", "true", "false"], case_sensitive=False,
            default="false", show_default=True,
            help="Image-embedding policy for the .slp output: "
                 "false (backreference media), true (self-contained "
                 ".pkg.slp), auto (embed iff the input was embedded)."),
        O("--restore-source-videos/--no-restore-source-videos",
            "--restore_source_videos/--no-restore_source_videos",
            "restore_source_videos", default=False,
            help="On a non-embedding save, restore references to the "
                 "pre-embedding source videos when recorded."),
        O("--stream-to-file", "--stream_to_file", "stream_to_file",
            default=None,
            help="Write predictions to this .slp via the incremental "
                 "writer (crash-safe temp flushes, atomic finalize)."),
        O("--write-interval", "--write_interval", "write_interval",
            default=None, type=int,
            help="Flush cadence (frames) for --stream-to-file "
                 "(default 500)."),
        O("--gui", is_flag=True, default=False,
            help="Emit JSON-lines progress for GUI integration."),
        O("--queue-maxsize", "--queue_maxsize", "queue_maxsize",
            type=int, default=32, show_default=True,
            help="Max decoded frames buffered ahead of the device "
                 "(provider prefetch bound, reference VideoReader "
                 "queue knob)."),
        # -- runtime / device ---------------------------------------------------
        O("--device", "-d", default=None,
            choices=["auto", "cuda", "cpu"],
            help="Compute device: the card unless 'cpu' (unset and 'auto' mean the card, and raise without one)."),
        O("--batch-size", "--batch_size", "-b", "batch_size",
            default=4, show_default=True),
        O("--runtime", default="auto", show_default=True,
            choices=["auto", "pt2", "stablehlo", "savedmodel"],
            help="Runtime for an exported model dir passed to "
                 "--model-paths (pt2: a torch.export program; the JAX "
                 "package's stablehlo and savedmodel are refused)."),
        O("--use-bf16/--no-use-bf16", "--use_bf16/--no-use_bf16",
            "use_bf16", default=False, show_default=True,
            help="bfloat16 forward pass (the card's fast path)."),
        O("--data-parallel/--no-data-parallel",
            "--data_parallel/--no-data_parallel", "data_parallel",
            default=False, show_default=True,
            help="Data-parallel inference over all local cards: each batch's "
                 "rows split evenly over one replica of the models per card. "
                 "--batch-size must divide by the card count. Currently "
                 "slower than one card: one host thread enqueues every "
                 "replica's work."),
        O("--host-resize/--no-host-resize", "host_resize",
            default=False, show_default=True,
            help="Downscale frames on the host before transfer "
                 "(cuts H2D payload; cv2 bilinear instead of the "
                 "on-device resize)."),
        O("--paf-workers", "--paf_workers", "paf_workers",
            default=0, show_default=True,
            help="Worker processes for bottom-up PAF grouping (0 = inline)."),
        O("--cpu-workers", "--cpu_workers", "cpu_workers",
            default=None, type=int,
            help="[DEPRECATED] Use --paf-workers."),
        O("--profile-dir", default=None,
            help="Write a torch.profiler trace of the predict loop into this "
                 "directory (TensorBoard / Perfetto)."),
        # -- frame / source scoping ---------------------------------------------
        O("--frames", default=None,
            help="Frame range like 0-100 or comma list."),
        O("--video-index", "--video_index", "video_index",
            default=None, type=int,
            help="Restrict a multi-video .slp source to one video."),
        O("--video-dataset", "--video_dataset", "video_dataset",
            default=None,
            help="HDF5 dataset path for an .h5 video source."),
        O("--video-input-format", "--video_input_format",
            "video_input_format", default="channels_last",
            show_default=True,
            help="Axis order of an HDF5 video dataset."),
        O("--video-path-map", default=None,
            help="Remap .slp video paths: 'old=new' (repeatable via "
                 "comma: 'a=b,c=d')."),
        O("--only-labeled-frames", "--only_labeled_frames",
            "only_labeled_frames", is_flag=True, default=False,
            help="Predict only on frames with user labels."),
        O("--only-suggested-frames/--all-frames",
            "--only_suggested_frames/--all_frames",
            "only_suggested_frames", default=False, show_default=True,
            help="Predict on the .slp's suggested frames instead of "
                 "its labeled frames."),
        O("--only-predicted-frames", "--only_predicted_frames",
            "only_predicted_frames", is_flag=True, default=False,
            help="Predict only on frames that already have predictions."),
        O("--exclude-user-labeled/--include-user-labeled",
            "--exclude_user_labeled/--include_user_labeled",
            "exclude_user_labeled", default=False, show_default=True,
            help="Skip frames that already carry user labels."),
        O("--no-empty-frames/--keep-empty-frames",
            "--no_empty_frames/--keep_empty_frames",
            "no_empty_frames", default=False, show_default=True,
            help="Drop frames with no predictions before saving."),
        # -- model / preprocessing ----------------------------------------------
        O("--backbone-ckpt-path", "--backbone_ckpt_path",
            "backbone_ckpt_path", default=None,
            help="Swap the backbone weights from another checkpoint."),
        O("--head-ckpt-path", "--head_ckpt_path", "head_ckpt_path",
            default=None,
            help="Swap the head weights from another checkpoint."),
        O("--max-height", "--max_height", "max_height",
            default=None, type=int),
        O("--max-width", "--max_width", "max_width",
            default=None, type=int),
        O("--input-scale", "--input_scale", "input_scale",
            default=None, type=float),
        O("--ensure-rgb/--no-ensure-rgb",
            "--ensure_rgb/--no-ensure_rgb", "ensure_rgb", default=None,
            help="Force RGB conversion of input frames."),
        O("--ensure-grayscale/--no-ensure-grayscale",
            "--ensure_grayscale/--no-ensure_grayscale",
            "ensure_grayscale", default=None,
            help="Force grayscale conversion of input frames."),
        O("--crop-size", "--crop_size", "crop_size",
            default=None, type=int),
        O("--anchor-part", "--anchor_part", "anchor_part",
            default=None,
            help="Skeleton node used as the GT-centroid anchor "
                 "(centered-instance-only inference)."),
        # -- peaks --------------------------------------------------------------
        O("--peak-threshold", "--peak_threshold",
            "--peak-conf-threshold", "peak_threshold",
            default=0.2, show_default=True,
            help="Min confmap value for a valid peak."),
        O("--centroid-peak-threshold", "--centroid_peak_threshold",
            "centroid_peak_threshold", default=None, type=float,
            help="Separate stage-1 (centroid) threshold for topdown."),
        O("--max-instances", "--max_instances", "-n",
            "max_instances", default=None, type=int),
        O("--max-peaks", default=200, show_default=True),
        O("--integral-refinement", "--integral_refinement",
            "--refinement", "refinement", default="integral",
            show_default=True,
            choices=["integral", "local", "none"]),
        O("--integral-patch-size", "--integral_patch_size",
            "integral_patch_size", default=5, show_default=True),
        O("--centroid-only/--full-pipeline",
            "--centroid_only/--full_pipeline", "centroid_only",
            default=False, show_default=True,
            help="Run only the centroid stage of a topdown pair."),
        O("--centroid-output", "--centroid_output",
            "centroid_output", default="instance", show_default=True,
            choices=["instance", "centroid", "both"],
            help="Centroid-only output representation."),
        # -- PAF grouping (bottomup) ---------------------------------------------
        O("--max-edge-length-ratio", "--max_edge_length_ratio",
            "max_edge_length_ratio", default=0.25, show_default=True),
        O("--dist-penalty-weight", "--dist_penalty_weight",
            "dist_penalty_weight", default=1.0, show_default=True),
        O("--n-points", "--n_points", "n_points",
            default=10, show_default=True),
        O("--min-instance-peaks", "--min_instance_peaks",
            "min_instance_peaks", default=0.0, show_default=True),
        O("--min-line-scores", "--min_line_scores",
            "min_line_scores", default=0.25, show_default=True),
        # -- segmentation ---------------------------------------------------------
        O("--fg-threshold", "--fg_threshold", "fg_threshold",
            default=0.5, show_default=True,
            help="Foreground probability cutoff (segmentation models)."),
        O("--min-mask-area", "--min_mask_area", "min_mask_area",
            default=0, show_default=True,
            help="Drop predicted masks smaller than this many "
                 "ORIGINAL-image pixels (converted to grid units "
                 "when masks stay at output-stride resolution). "
                 "0 disables (reference default)."),
        O("--center-nms-kernel", "--center_nms_kernel",
            "center_nms_kernel", default=3, show_default=True, type=int,
            help="Odd NMS window for instance-center peaks; larger "
                 "merges nearby duplicate centers."),
        O("--mask-cleanup/--no-mask-cleanup",
            "--mask_cleanup/--no-mask_cleanup", "mask_cleanup",
            default=True, show_default=True,
            help="Keep each mask's largest connected component and "
                 "fill interior holes."),
        O("--mask-cleanup-radius", "--mask_cleanup_radius",
            "mask_cleanup_radius", default=0, show_default=True, type=int,
            help="Disk radius for a morphological open->close before "
                 "cleanup (despeckle / close pinholes)."),
        O("--distance-gate-alpha", "--distance_gate_alpha",
            "distance_gate_alpha", default=None, type=float,
            help="Scale-free stray-pixel gate: drop fg pixels whose "
                 "voted center exceeds alpha*sqrt(area/pi) from the "
                 "assigned center."),
        O("--merge-fragments/--no-merge-fragments",
            "--merge_fragments/--no-merge_fragments",
            "merge_fragments", default=False, show_default=True,
            help="Fuse over-segmented mask fragments (bottom-up segmentation)."),
        O("--merge-method", "--merge_method", "merge_method",
            default="greedy", show_default=True,
            choices=["greedy", "multicut"],
            help="Fragment-merge strategy (with --merge-fragments)."),
        O("--merge-thresholds", "--merge_thresholds",
            "merge_thresholds", type=_comma_floats,
            default=(0.85, 0.6, 0.4), show_default=True,
            help="Decreasing affinity thresholds for greedy merging."),
        O("--merge-w-valley", "--merge_w_valley", "merge_w_valley",
            default=1.0, show_default=True,
            help="Weight of the center-valley ridge affinity term."),
        O("--merge-w-offset", "--merge_w_offset", "merge_w_offset",
            default=0.25, show_default=True,
            help="Weight of the offset-agreement affinity term."),
        O("--merge-dilate", "--merge_dilate", "merge_dilate",
            default=1, show_default=True, type=int,
            help="Dilation iterations for the fragment contact test."),
        O("--full-res-masks/--no-full-res-masks",
            "--full_res_masks/--no-full_res_masks", "full_res_masks",
            default=False, show_default=True,
            help="Emit masks at ORIGINAL image resolution instead of "
                 "the output-stride grid."),
        O("--mask-output", "--mask_output", "mask_output",
            default="mask", show_default=True,
            choices=["mask", "polygon", "both"],
            help="Mask representation: dense mask, simplified "
                 "polygon ROI, or both."),
        O("--polygon-epsilon", "--polygon_epsilon",
            "polygon_epsilon", default=0.01, show_default=True,
            help="Douglas-Peucker tolerance as a fraction of the "
                 "contour perimeter (0 disables)."),
        # -- SAM prompted-mask producer -------------------------------------------
        O("--mask-backend", "--mask_backend", "mask_backend",
            default=None, choices=["sam", "sam_jax", "sam3"], case_sensitive=False,
            help="Produce instance masks from the poses in the input "
                 ".slp via a SAM backend (no trained model; omit "
                 "--model-paths)."),
        O("--sam-checkpoint", "--sam_checkpoint", "sam_checkpoint",
            default=None,
            help="Path to the SAM1 checkpoint (--mask-backend sam)."),
        O("--sam-model-type", "--sam_model_type", "sam_model_type",
            default="vit_h", show_default=True,
            help="SAM1 model registry key."),
        O("--sam-prompt-mode", "--sam_prompt_mode",
            "sam_prompt_mode", default="pose", show_default=True,
            choices=["pose", "centroid", "box"]),
        O("--sam-anchor-ind", "--sam_anchor_ind", "sam_anchor_ind",
            default=None, type=int,
            help="Centroid anchor node index (prompt mode centroid)."),
        O("--sam-disjointify-masks", "--sam_disjointify_masks",
            "sam_disjointify_masks", is_flag=True, default=False,
            help="Make per-frame masks disjoint when overlapping."),
        O("--sam3-model-id", "--sam3_model_id", "sam3_model_id",
            default="facebook/sam3", show_default=True,
            help="Hugging Face model id for the SAM3 backend."),
        O("--overlay-path", "--overlay_path", "overlay_path",
            default=None,
            help="Optional review-overlay PNG written by the SAM path."),
        # -- instance filters -------------------------------------------------------
        O("--filter-overlapping", "--filter_overlapping",
            "filter_overlapping", is_flag=True, default=False,
            help="Suppress overlapping instances (see "
                 "--filter-overlapping-method)."),
        O("--filter-overlapping-method",
            "--filter_overlapping_method", "filter_overlapping_method",
            default="iou", show_default=True,
            choices=["iou", "oks"]),
        O("--filter-overlapping-threshold",
            "--filter_overlapping_threshold",
            "filter_overlapping_threshold", default=0.8,
            show_default=True),
        O("--filter-min-visible-nodes", "--filter_min_visible_nodes",
            "filter_min_visible_nodes", default=None, type=int,
            help="Drop instances with fewer visible nodes."),
        O("--filter-min-visible-node-fraction",
            "--filter_min_visible_node_fraction",
            "filter_min_visible_node_fraction", default=None, type=float,
            help="Drop instances with a lower visible-node fraction."),
        O("--filter-min-mean-node-score",
            "--filter_min_mean_node_score",
            "filter_min_mean_node_score", default=None, type=float,
            help="Drop instances whose mean visible-node score is lower."),
        O("--filter-min-node-confidence",
            "--filter_min_node_confidence",
            "filter_min_node_confidence", default=None, type=float,
            help="NaN-out nodes below this confidence."),
        O("--filter-min-instance-score",
            "--filter_min_instance_score", "filter_min_instance_score",
            default=None, type=float,
            help="Drop instances below this score."),
        O("--filter-min-centroid-distance",
            "--filter_min_centroid_distance",
            "filter_min_centroid_distance", default=None, type=float,
            help="Greedy NMS radius (px) for centroid-only output "
                 "de-duplication."),
        # -- tracking ------------------------------------------------------------
        O("--tracking/--no-tracking", "-t", "tracking",
            default=False, show_default=True),
        O("--tracking-window-size", "--tracking_window_size",
            "tracking_window_size", default=5, show_default=True),
        O("--min-new-track-points", "--min_new_track_points",
            "min_new_track_points", default=0, show_default=True),
        O("--candidates-method", "--candidates_method",
            "candidates_method", default=None,
            choices=["fixed_window", "local_queues"],
            help="Candidate pool strategy; --max-tracks auto-selects "
                 "local_queues."),
        O("--min-match-points", "--min_match_points",
            "min_match_points", default=0, show_default=True),
        O("--features", default=None,
            choices=["keypoints", "centroids", "bboxes",
                               "masks"],
            help="Track-association feature. Left unset, centroid "
                 "models resolve to centroids and mask models to masks."),
        O("--scoring-method", "--scoring_method",
            "--tracking-scoring-method", "scoring_method", default=None,
            choices=["oks", "cosine_sim", "iou", "mask_iou",
                               "euclidean_dist"],
            help="Track-association scoring. Left unset, centroid "
                 "models resolve to euclidean_dist and mask models "
                 "to mask_iou."),
        O("--scoring-reduction", "--scoring_reduction",
            "scoring_reduction", default="mean", show_default=True,
            choices=["mean", "max", "robust_quantile"]),
        O("--robust-best-instance", "--robust_best_instance",
            "robust_best_instance", default=1.0, show_default=True),
        O("--track-matching-method", "--track_matching_method",
            "track_matching_method", default="hungarian",
            show_default=True, choices=["hungarian", "greedy"]),
        O("--max-tracks", "--max_tracks", "--tracking-max-tracks",
            "max_tracks", default=None, type=int),
        O("--use-flow", "--use_flow", "--tracking-use-flow",
            "use_flow", is_flag=True, default=False),
        O("--of-img-scale", "--of_img_scale", "of_img_scale",
            default=1.0, show_default=True,
            help="Image scale for optical-flow computation."),
        O("--of-window-size", "--of_window_size", "of_window_size",
            default=21, show_default=True),
        O("--of-max-levels", "--of_max_levels", "of_max_levels",
            default=3, show_default=True),
        O("--use-kalman", "--use_kalman", "use_kalman",
            is_flag=True, default=False),
        O("--kf-track-features", "--kf_track_features",
            "kf_track_features", default="centroid", show_default=True,
            choices=["centroid", "keypoints"]),
        O("--kf-init-frame-count", "--kf_init_frame_count",
            "kf_init_frame_count", default=10, show_default=True),
        O("--kf-node-indices", "--kf_node_indices",
            "kf_node_indices", default=None, type=_int_list,
            help="Comma-separated node indices the Kalman filter tracks."),
        O("--kf-reset-gap-size", "--kf_reset_gap_size",
            "kf_reset_gap_size", default=5, show_default=True),
        O("--oks-stddev", "--oks_stddev", "oks_stddev",
            default=None, type=float,
            help="OKS spread for tracking association (auto-resolved "
                 "when unset)."),
        O("--post-connect-single-breaks",
            "--post_connect_single_breaks",
            "post_connect_single_breaks", is_flag=True, default=False),
        O("--tracking-target-instance-count",
            "--tracking_target_instance_count",
            "tracking_target_instance_count", default=None, type=int),
        O("--tracking-pre-cull-to-target",
            "--tracking_pre_cull_to_target",
            "tracking_pre_cull_to_target", default=0, show_default=True,
            type=int),
        O("--tracking-pre-cull-iou-threshold",
            "--tracking_pre_cull_iou_threshold",
            "tracking_pre_cull_iou_threshold", default=0.0,
            show_default=True),
        O("--tracking-clean-instance-count",
            "--tracking_clean_instance_count",
            "tracking_clean_instance_count", default=0,
            show_default=True, type=int),
        O("--tracking-clean-iou-threshold",
            "--tracking_clean_iou_threshold",
            "tracking_clean_iou_threshold", default=0.0,
            show_default=True),
]


def _parse_frames(frames: Optional[str]):
    """'n-m' (or the legacy 'n,-m' spelling) -> range; 'a,b,c' -> list.
    Any string holding '-' is a range, with a trailing comma stripped from
    the lower bound, so '1,-200' means frames 1..200."""
    if not frames:
        return None
    if "-" in frames:
        lo, hi = frames.split("-")
        return list(range(int(lo.rstrip(",")), int(hi) + 1))
    return [int(x) for x in frames.split(",")]


def _default_predictions_path(data_path) -> str:
    """The default output ``.slp`` beside the input; a remote URL gives its
    basename (query dropped) in the current directory."""
    from sleap_nn_tpu_torch.inference.run import is_remote_url

    s = str(data_path)
    if is_remote_url(s):
        from urllib.parse import unquote, urlparse

        name = unquote(Path(urlparse(s).path).name) or "remote_data"
        return str(Path(name).with_suffix("")) + ".predictions.slp"
    return str(Path(s).with_suffix("")) + ".predictions.slp"


def _parse_headers(raw) -> Optional[dict]:
    """--headers JSON string -> dict for a remote input's request."""
    if not raw:
        return None
    try:
        parsed = json.loads(raw)
    except json.JSONDecodeError as e:
        raise UsageError(f"--headers must be a JSON object: {e}")
    if not isinstance(parsed, dict):
        raise UsageError("--headers must be a JSON object of strings.")
    return {str(k): str(v) for k, v in parsed.items()}


_TRACKER_KNOBS = (
    "tracking_window_size", "min_new_track_points", "candidates_method",
    "min_match_points", "features", "scoring_method", "scoring_reduction",
    "robust_best_instance", "track_matching_method", "max_tracks", "use_flow",
    "of_img_scale", "of_window_size", "of_max_levels", "use_kalman",
    "kf_track_features", "kf_init_frame_count", "kf_node_indices",
    "kf_reset_gap_size", "oks_stddev", "post_connect_single_breaks",
    "tracking_target_instance_count", "tracking_pre_cull_to_target",
    "tracking_pre_cull_iou_threshold", "tracking_clean_instance_count",
    "tracking_clean_iou_threshold",
)


def _build_tracker_kwargs(kw: dict) -> dict:
    """Pop the tracking options out of the parsed options and shape them
    for ``run_tracker``. ``--post-connect-single-breaks`` without
    ``--max-tracks`` takes the track cap from ``--max-instances``, and
    post-connect, pre-cull or Kalman without
    ``--tracking-target-instance-count`` take the target count from it."""
    vals = {k: kw.pop(k) for k in _TRACKER_KNOBS}
    if not kw.pop("tracking"):
        return {}
    max_instances = kw.get("max_instances")
    if vals["post_connect_single_breaks"] and vals["max_tracks"] is None:
        vals["max_tracks"] = max_instances
    needs_target = (
        vals["post_connect_single_breaks"]
        or vals["tracking_pre_cull_to_target"]
        or vals["use_kalman"]
    )
    if needs_target and vals["tracking_target_instance_count"] is None:
        vals["tracking_target_instance_count"] = max_instances
    out = dict(
        tracking=True,
        window_size=vals["tracking_window_size"],
        min_new_track_points=vals["min_new_track_points"],
        min_match_points=vals["min_match_points"],
        scoring_reduction=vals["scoring_reduction"],
        robust_best_instance=vals["robust_best_instance"],
        track_matching_method=vals["track_matching_method"],
        max_tracks=vals["max_tracks"],
        use_flow=vals["use_flow"],
        use_kalman=vals["use_kalman"],
        kf_track_features=vals["kf_track_features"],
        kf_init_frame_count=vals["kf_init_frame_count"],
        kf_reset_gap_size=vals["kf_reset_gap_size"],
        of_img_scale=vals["of_img_scale"],
        of_window_size=vals["of_window_size"],
        of_max_levels=vals["of_max_levels"],
        post_connect_single_breaks=vals["post_connect_single_breaks"],
        target_instance_count=vals["tracking_target_instance_count"],
        pre_cull_to_target=bool(vals["tracking_pre_cull_to_target"]),
        pre_cull_iou_threshold=vals["tracking_pre_cull_iou_threshold"],
        clean_instance_count=vals["tracking_clean_instance_count"],
        clean_iou_threshold=vals["tracking_clean_iou_threshold"],
    )
    # Unset means "the model type decides" downstream (a one-node skeleton
    # tracks centroids by euclidean distance).
    for k in ("candidates_method", "features", "scoring_method", "oks_stddev",
              "kf_node_indices"):
        if vals[k] is not None:
            out[k] = vals[k]
    return out


class _ProgressLine:
    """The interactive progress: one stderr line, rewritten in place, with
    the frames done and the rolling frames/s."""

    def __init__(self):
        self.fps_of = make_rolling_fps()
        self.shown = False

    def __call__(self, n_done):
        sys.stderr.write(f"\rPredicting... {n_done} frames {self.fps_of(n_done)}\x1b[K")
        sys.stderr.flush()
        self.shown = True

    def close(self):
        if self.shown:
            sys.stderr.write("\r\x1b[K")
            sys.stderr.flush()


def _run_inference(**kw):
    from sleap_nn_tpu_torch.inference import run

    cpu_workers = kw.pop("cpu_workers", None)
    if cpu_workers is not None:
        echo("WARNING: --cpu-workers is deprecated; use --paf-workers.", err=True)
        if not kw.get("paf_workers"):
            kw["paf_workers"] = cpu_workers

    tracker_kwargs = _build_tracker_kwargs(kw)

    gui = kw.pop("gui")
    progress_ui = None
    if gui:
        def _gui_progress(n_done):
            echo(json.dumps({"n_processed": int(n_done)}))

        kw["progress_callback"] = _gui_progress
    elif sys.stderr.isatty():
        progress_ui = _ProgressLine()
        kw["progress_callback"] = progress_ui

    out_fmt = kw.pop("output_format") or ("slp",)
    kw["output_format"] = list(out_fmt)

    # The streaming writer bypasses the in-memory Labels post-passes, so
    # options that need them are refused with it.
    if kw.get("stream_to_file"):
        if tracker_kwargs:
            raise UsageError(
                "--stream-to-file cannot be combined with --tracking; "
                "track the written file afterwards with `track-only`."
            )
        if kw.get("no_empty_frames"):
            raise UsageError("--stream-to-file cannot be combined with --no-empty-frames.")
        if str(kw.get("embed", "false")).lower() == "true":
            raise UsageError("--stream-to-file cannot be combined with --embed true.")
    elif kw.get("write_interval") is not None:
        raise UsageError("--write-interval only applies with --stream-to-file.")

    # --embed: auto embeds iff the input was itself an embedded .pkg.slp.
    embed_choice = str(kw.pop("embed")).lower()
    data_path = kw.pop("data_path")
    kw["embed"] = (
        embed_choice == "true"
        or (embed_choice == "auto" and str(data_path).endswith(".pkg.slp"))
    )

    from sleap_nn_tpu_torch.inference.filters import FilterConfig

    overlap_on = kw.pop("filter_overlapping")
    overlap_method = kw.pop("filter_overlapping_method")  # always consumed
    fc = FilterConfig(
        min_node_count=kw.pop("filter_min_visible_nodes"),
        min_node_confidence=kw.pop("filter_min_node_confidence"),
        min_instance_score=kw.pop("filter_min_instance_score"),
        overlap_method=overlap_method if overlap_on else None,
        overlap_threshold=kw.pop("filter_overlapping_threshold"),
        max_centroid_distance=kw.pop("filter_min_centroid_distance"),
        min_visible_node_fraction=kw.pop("filter_min_visible_node_fraction"),
        min_mean_node_score=kw.pop("filter_min_mean_node_score"),
    )
    if fc.enabled():
        kw["filters"] = fc

    # SAM prompted masks: poses from the input .slp, no trained model.
    mask_backend = kw.pop("mask_backend")
    sam_checkpoint = kw.pop("sam_checkpoint")
    kw.pop("sam_model_type")
    sam3_model_id = kw.pop("sam3_model_id")
    kw["sam_overlay_path"] = kw.pop("overlay_path")
    if mask_backend is not None:
        kw["mask_backend"] = mask_backend
        if mask_backend == "sam3":
            kw["sam_model_id"] = sam3_model_id
        elif sam_checkpoint:
            kw["sam_model_id"] = sam_checkpoint

    model_paths = list(kw.pop("model_paths") or ())
    if (
        mask_backend is None
        and not model_paths
        and tracker_kwargs
        and str(data_path).endswith(".slp")
    ):
        # Tracking-only retrack: --tracking on a .slp with no model re-tracks
        # its predictions, with no inference; prior tracks are discarded.
        return _run_retrack_only(data_path, kw, tracker_kwargs, gui)
    if mask_backend is None and not model_paths:
        raise UsageError(
            "Provide --model-paths (trained model dir(s) or an export dir), "
            "or --mask-backend for SAM prompted masks; or combine "
            "--tracking with a predictions .slp for tracking-only retrack."
        )
    if mask_backend is not None and model_paths:
        raise UsageError(
            "--mask-backend produces masks from the poses already in the "
            "input .slp; do not pass --model-paths with it."
        )

    output_path = kw.pop("output_path")
    frames = _parse_frames(kw.pop("frames"))
    if output_path is None:
        output_path = _default_predictions_path(data_path)

    # Remote-input options: the JSON --headers string as a dict; a remote
    # input is read download-first unless --stream-mode says otherwise.
    kw["headers"] = _parse_headers(kw.get("headers"))
    kw["stream_mode"] = kw.get("stream_mode") or "download"

    try:
        labels = run.predict(
            data_path,
            model_paths,
            output_path=output_path,
            frames=frames,
            **kw,
            **tracker_kwargs,
        )
    except Exception as e:
        # GUI mode reads stdout JSON lines: the failure goes out as one,
        # and is raised again so that the exit code shows it.
        if gui:
            echo(json.dumps({"error": str(e)}))
        raise
    finally:
        if progress_ui is not None:
            progress_ui.close()
    n_inst = sum(len(lf.instances) for lf in labels)
    n_masks = sum(len(getattr(lf, "masks", ()) or ()) for lf in labels)
    msg = f"Predicted {len(labels)} frames, {n_inst} instances"
    if n_masks:
        msg += f", {n_masks} masks"
    echo(msg + f" -> {output_path}", err=gui)
    if gui:
        echo(json.dumps({
            "done": True, "n_frames": len(labels), "n_instances": n_inst,
            "output_path": str(output_path),
        }))
    return labels


def _run_retrack_only(data_path, kw: dict, tracker_kwargs: dict, gui: bool):
    """Tracking-only retrack of a predictions ``.slp``: drop its tracks,
    run the tracker, attach tracking-only provenance. Honors
    ``--output-format``, ``--embed``, ``--frames`` and ``--video-index``;
    options that need inference are refused."""
    if kw.get("filters") is not None:
        raise UsageError(
            "--filter-* options require inference and cannot be combined "
            "with tracking-only retrack (no --model-paths)."
        )
    if kw.get("only_suggested_frames"):
        raise UsageError(
            "--only-suggested-frames requires inference; tracking-only "
            "retrack operates on the file's existing predictions."
        )
    try:
        return _retrack_inner(data_path, kw, tracker_kwargs, gui)
    except UsageError:
        raise
    except Exception as e:
        if gui:
            echo(json.dumps({"error": str(e)}))
        raise


def _retrack_inner(data_path, kw: dict, tracker_kwargs: dict, gui: bool):
    from datetime import datetime

    from sleap_nn_tpu_torch import tracking
    from sleap_nn_tpu_torch.inference.provenance import build_tracking_only_provenance
    from sleap_nn_tpu_torch.inference.run import save_predictions
    from sleap_nn_tpu_torch.io import load_slp

    labels = load_slp(str(data_path))
    frames = _parse_frames(kw.get("frames"))
    if frames:
        wanted = set(frames)
        labels.labeled_frames = [
            lf for lf in labels.labeled_frames if lf.frame_idx in wanted
        ]
    video_index = kw.get("video_index")
    if video_index is not None:
        if not 0 <= video_index < len(labels.videos):
            raise UsageError(
                f"--video-index {video_index} out of range for "
                f"{len(labels.videos)} video(s)."
            )
        vid = labels.videos[video_index]
        labels.labeled_frames = [
            lf for lf in labels.labeled_frames if lf.video is vid
        ]
    for lf in labels.labeled_frames:
        for inst in lf.instances:
            inst.track = None
    labels.tracks = []

    run_kwargs = dict(tracker_kwargs)
    run_kwargs.pop("tracking", None)
    t0 = datetime.now()
    labels = tracking.run_tracker(labels, **run_kwargs)
    labels.provenance = build_tracking_only_provenance(
        input_labels=labels,
        input_path=data_path,
        start_time=t0,
        end_time=datetime.now(),
        tracking_params=run_kwargs,
        frames_processed=len(labels.labeled_frames),
    )
    output_path = kw.get("output_path") or _default_predictions_path(data_path)
    save_predictions(
        labels, output_path,
        output_format=kw.get("output_format") or "slp",
        embed=bool(kw.get("embed")),
    )
    echo(f"Retracked {len(labels)} frames into {len(labels.tracks)} tracks "
         f"-> {output_path}", err=gui)
    if gui:
        echo(json.dumps({
            "done": True, "n_frames": len(labels),
            "n_tracks": len(labels.tracks), "output_path": str(output_path),
        }))
    return labels


@command("predict", INFERENCE_OPTIONS)
def predict(**kw):
    """Run inference on a video or labels file."""
    _run_inference(**kw)


@command("infer", INFERENCE_OPTIONS, hidden=True)
def infer(**kw):
    """Hidden alias of predict."""
    import warnings

    warnings.warn(
        "sleap-nn-tpu-torch infer is deprecated. Use sleap-nn-tpu-torch predict instead.",
        DeprecationWarning,
        stacklevel=2,
    )
    _run_inference(**kw)


@command("track", INFERENCE_OPTIONS)
def track(**kw):
    """Run inference with tracking enabled."""
    kw["tracking"] = True
    _run_inference(**kw)


@command("sam", [
    Opt("--data-path", "-i", required=True, exists=True,
        help="Pose .slp/.pkg.slp to produce masks for."),
    Opt("--mask-backend", required=True, choices=["sam", "sam_jax", "sam_legacy", "sam3"],
        help="Explicit mask backend (no default)."),
    Opt("--output-path", "-o", default=None),
    Opt("--prompt-mode", default="pose", show_default=True,
        choices=["pose", "centroid", "box"]),
    Opt("--sam-model-id", default="facebook/sam-vit-huge", show_default=True),
    Opt("--anchor-ind", default=None, type=int,
        help="Centroid anchor node index (prompt-mode=centroid)."),
    Opt("--disjointify/--no-disjointify", default=False, show_default=True,
        help="Make per-frame masks disjoint via keypoint-Voronoi."),
    Opt("--overlay-path", default=None, help="Review overlay PNG path."),
    Opt("--frames", default=None, help="Frame subset, e.g. 0-100 or 3,7,9."),
])
def sam_cmd(data_path, mask_backend, output_path, prompt_mode, sam_model_id,
            anchor_ind, disjointify, overlay_path, frames):
    """Predict per-instance SAM masks for an existing pose .slp (review workflow)."""
    from sleap_nn_tpu_torch.inference.sam import run_sam_segmentation

    if output_path is None:
        output_path = str(Path(data_path).with_suffix("")) + ".masks.slp"
    labels = run_sam_segmentation(
        data_path,
        mask_backend,
        prompt_mode=prompt_mode,
        sam_model_id=sam_model_id,
        anchor_ind=anchor_ind,
        disjointify_masks=disjointify,
        output_path=output_path,
        overlay_path=overlay_path,
        frames=_parse_frames(frames),
    )
    n_masks = sum(len(lf.masks) for lf in labels)
    echo(f"Masked {len(labels)} frames, {n_masks} masks -> {output_path}")


@command("track-only", [
    Opt("--data-path", "-i", required=True, help="Predicted .slp to re-track."),
    Opt("--output-path", "-o", default=None),
    Opt("--window-size", default=5, show_default=True),
    Opt("--scoring-method", default="oks", show_default=True),
    Opt("--max-tracks", default=None, type=int),
    Opt("--target-instance-count", default=None, type=int,
        help="Expected instances per frame (enables culling / break repair)."),
    Opt("--pre-cull-to-target/--no-pre-cull-to-target", default=False,
        show_default=True, help="Cull frames to the target count before tracking."),
    Opt("--pre-cull-iou-threshold", default=0.0, show_default=True),
    Opt("--post-connect-single-breaks/--no-post-connect-single-breaks",
        default=False, show_default=True,
        help="Merge single-frame track breaks after tracking."),
])
def track_only(data_path, output_path, window_size, scoring_method, max_tracks,
               target_instance_count, pre_cull_to_target, pre_cull_iou_threshold,
               post_connect_single_breaks):
    """Assign tracks to an existing predictions file (no model inference)."""
    from datetime import datetime

    from sleap_nn_tpu_torch import tracking
    from sleap_nn_tpu_torch.inference.provenance import build_tracking_only_provenance
    from sleap_nn_tpu_torch.io import load_slp

    labels = load_slp(data_path)
    t0 = datetime.now()
    tracking_params = dict(
        window_size=window_size, scoring_method=scoring_method,
        max_tracks=max_tracks,
        target_instance_count=target_instance_count,
        pre_cull_to_target=pre_cull_to_target,
        pre_cull_iou_threshold=pre_cull_iou_threshold,
        post_connect_single_breaks=post_connect_single_breaks,
    )
    labels = tracking.run_tracker(labels, **tracking_params)
    labels.provenance = build_tracking_only_provenance(
        input_labels=labels,
        input_path=data_path,
        start_time=t0,
        end_time=datetime.now(),
        tracking_params=tracking_params,
        frames_processed=len(labels.labeled_frames),
    )
    out = output_path or str(Path(data_path).with_suffix("")) + ".tracked.slp"
    labels.save(out)
    echo(f"Tracked {len(labels.tracks)} tracks -> {out}")


@command("eval", [
    Opt("--ground-truth", "--ground-truth-path", "--ground_truth_path",
        "-g", "ground_truth", required=True, exists=True,
        help="Path to ground truth labels (.slp)."),
    Opt("--predictions", "--predicted-path", "--predicted_path", "-p",
        "predictions", required=True, exists=True,
        help="Path to predicted labels (.slp)."),
    Opt("--save-metrics", "--save_metrics", "-s", "save_metrics",
        default=None, help="Optional .npz output path."),
    Opt("--oks-stddev", "--oks_stddev", "oks_stddev", default=0.025, show_default=True),
    Opt("--oks-scale", "--oks_scale", "oks_scale", default=None,
        type=float, help="Fixed OKS object scale (default: GT bbox area)."),
    Opt("--match-threshold", "--match_threshold", "match_threshold",
        default=0.0, show_default=True),
    Opt("--user-labels-only/--no-user-labels-only",
        "--user_labels_only/--no-user_labels_only", "user_labels_only",
        default=True, show_default=True,
        help="Only evaluate user-labeled frames."),
    Opt("--match-method", "--match_method", "match_method",
        default="auto", show_default=True,
        choices=["oks", "centroid", "mask", "semantic", "auto"]),
    Opt("--anchor-part", "--anchor_part", "anchor_part", default=None,
        help="GT node for ground-truth centroids in centroid mode."),
])
def eval_cmd(ground_truth, predictions, save_metrics, oks_stddev, oks_scale,
             match_threshold, user_labels_only, match_method, anchor_part):
    """Evaluate predictions against ground truth labels."""
    from sleap_nn_tpu_torch import evaluation

    metrics = evaluation.run_evaluation(
        ground_truth,
        predictions,
        oks_stddev=oks_stddev,
        oks_scale=oks_scale,
        match_threshold=match_threshold,
        user_labels_only=user_labels_only,
        match_method=match_method,
        anchor_part=anchor_part,
        save_metrics=save_metrics,
    )
    if metrics is None:
        echo("No usable predictions; metrics skipped.")
        return
    echo(json.dumps(eval_summary(metrics)))


def eval_summary(metrics: dict) -> dict:
    """The one-line summary ``eval`` prints: the headline pose metrics and
    the detection metrics, rounded to 5 places (NaN as null)."""
    summary = {}
    if "mOKS" in metrics:
        summary["mOKS"] = metrics["mOKS"]["mOKS"]
        summary["oks_voc.mAP"] = metrics["voc_metrics"]["oks_voc.mAP"]
        summary["oks_voc.mAR"] = metrics["voc_metrics"]["oks_voc.mAR"]
        summary["dist.avg"] = metrics["distance_metrics"]["avg"]
        summary["PCK@5"] = metrics["pck_metrics"]["PCK@5"]
    if "detection_metrics" in metrics:
        summary.update({f"detection.{k}": v for k, v in metrics["detection_metrics"].items()
                        if k in ("precision", "recall", "f1", "avg")})
    return {k: (round(float(v), 5) if v == v else None) for k, v in summary.items()}


@command("system", [])
def system():
    """Report devices / versions and run a device smoke test."""
    from sleap_nn_tpu_torch.system_info import get_startup_info_string

    echo(get_startup_info_string())


@command("info", [Arg("model_dir", exists=True)])
def info(model_dir):
    """Summarize a trained model directory."""
    from sleap_nn_tpu_torch.model_info import print_model_info

    print_model_info(model_dir)


@command("config", [
    Arg("path", required=False, exists=True),
    Opt("--output", "-o", default=None, help="Output config YAML path."),
    Opt("--auto", is_flag=True, default=False,
        help="Generate a config non-interactively with smart defaults."),
    Opt("--pipeline", default=None,
        choices=["topdown", "centroid", "bottomup", "single_instance",
                 "multi_class_topdown", "multi_class_bottomup"],
        help="Pipeline override for --auto mode."),
    Opt("--show-yaml", "--show_yaml", "show_yaml", is_flag=True,
        default=False, help="Print the generated YAML instead of saving."),
    Opt("--preset", default="quality", show_default=True,
        choices=["quality", "throughput"],
        help="--auto preset: 'throughput' applies the fast-inference knobs "
             "(output_stride=4, <=384 px scale, crop 128)."),
    Arg("overrides", required=False, nargs=-1),
])
def config_cmd(path, output, auto, pipeline, show_yaml, preset, overrides):
    """Validate a config YAML, or generate one from a SLEAP file.

    With a YAML argument: validate and print it (with optional dotted
    OVERRIDES). With an .slp argument: generate a recommended training
    config, with ``--auto`` without questions, otherwise in the interactive
    front end.
    """
    from sleap_nn_tpu_torch.config.base import to_yaml

    if path is not None and str(path).endswith((".yaml", ".yml", ".json")):
        from sleap_nn_tpu_torch.config import TrainingJobConfig, verify_training_cfg

        cfg = TrainingJobConfig.load_yaml(path, overrides=_parse_overrides(overrides))
        verify_training_cfg(cfg)
        echo(to_yaml(cfg))
        return None
    if not auto:
        from sleap_nn_tpu_torch.config_generator.tui import launch_tui

        launch_tui(path, output_path=output)
        return None
    if not path:
        raise UsageError("SLP_PATH is required for --auto mode.")
    from sleap_nn_tpu_torch.config_generator import (
        analyze_slp,
        generate_config,
        recommend_config,
    )
    from sleap_nn_tpu_torch.config_generator.recommender import recommend_throughput_preset

    stats = analyze_slp(path)
    rec = recommend_config(stats)
    if pipeline:
        rec.pipeline.pipeline = pipeline
        # The preset's knobs depend on the pipeline (a crop only for the
        # top-down families): recompute them for the one asked for.
        rec.throughput_preset = recommend_throughput_preset(stats, pipeline, rec.backbone)
    _require_preset(preset, rec)
    if show_yaml:
        echo(to_yaml(generate_config(path, output_path=None, stats=stats,
                                     recommendation=rec, preset=preset)))
        return None
    out = output or str(Path(path).parent / f"{Path(path).stem}_config.yaml")
    generate_config(path, output_path=out, stats=stats, recommendation=rec, preset=preset)
    if preset == "throughput":
        echo(f"Throughput preset: {rec.throughput_preset['note']}")
    echo(f"Saved config to: {out}")
    return None


def _require_preset(preset: str, rec) -> None:
    if preset == "throughput" and rec.throughput_preset is None:
        raise UsageError(
            f"No measured throughput preset for the recommended backbone "
            f"({rec.backbone}); rerun without --preset.")


@command("export", [
    Arg("model_dir", nargs=-1, exists=True),
    Opt("--output-dir", "--output", "-o", "output_dir", default=None),
    Opt("--format", "fmt", default="pt2", show_default=True,
        choices=["pt2", "stablehlo", "savedmodel"]),
    Opt("--batch-size", "--max-batch-size", "batch_size", default=4,
        show_default=True, help="Batch size baked into the exported graph."),
    Opt("--peak-threshold", default=0.2, show_default=True),
    Opt("--max-instances", default=20, show_default=True,
        help="Crop slots baked into topdown composite exports."),
    Opt("--max-peaks", "--max-peaks-per-node", "max_peaks", default=200,
        show_default=True, help="Peak slots baked into the graph."),
    Opt("--input-height", default=None, type=int, help="Override the baked input height."),
    Opt("--input-width", default=None, type=int, help="Override the baked input width."),
    Opt("--input-scale", default=None, type=float,
        help="Override the baked preprocessing scale."),
    Opt("--crop-size", default=None, type=int,
        help="Override the instance crop size (topdown composites)."),
    Opt("--precision", default="fp32", show_default=True, choices=["fp32", "bf16"],
        help="Forward-pass precision baked into the graph."),
    Opt("--n-line-points", default=10, show_default=True,
        help="PAF line samples baked into bottomup exports."),
    Opt("--max-edge-length-ratio", default=0.25, show_default=True),
    Opt("--dist-penalty-weight", default=1.0, show_default=True),
    Opt("--verify/--no-verify", "verify", default=True, show_default=True,
        help="Numerically verify the serialized graph against eager."),
    Opt("--device", default=None, hidden=True,
        help="Device to trace and verify on: the card unless 'cpu'."),
    Opt("--opset-version", default=None, type=int, hidden=True,
        help="[ONNX-only] Not applicable."),
    Opt("--workspace-size-gb", default=None, type=float, hidden=True,
        help="[TensorRT-only] Not applicable."),
])
def export(model_dir, fmt, device, opset_version, workspace_size_gb, **kw):
    """Export trained model(s) with baked postprocessing.

    Pass one model dir, or a centroid + instance-model pair for the fused
    topdown / multi_class_topdown composite program (model.pt2).
    """
    from sleap_nn_tpu_torch.export import export_model

    if opset_version is not None or workspace_size_gb is not None:
        echo("WARNING: --opset-version/--workspace-size-gb are ONNX/TensorRT "
             "knobs; torch.export programs ignore them.", err=True)
    dirs = list(model_dir)
    out = export_model(dirs if len(dirs) > 1 else dirs[0], fmt=fmt,
                       device=device or "cuda", **kw)
    echo(f"Exported to: {out}")


@command("config-generate", [
    Arg("slp_path", exists=True),
    Opt("--output", "-o", default=None, help="Output config YAML path."),
    Opt("--max-epochs", default=100, show_default=True),
    Opt("--preset", default="quality", show_default=True,
        choices=["quality", "throughput"],
        help="'throughput' applies the fast-inference knobs "
             "(output_stride=4, <=384 px scale, crop 128)."),
])
def config_generate(slp_path, output, max_epochs, preset):
    """Analyze a dataset and generate a recommended training config."""
    from sleap_nn_tpu_torch.config_generator import (
        analyze_slp,
        generate_config,
        recommend_config,
    )

    stats = analyze_slp(slp_path)
    rec = recommend_config(stats)
    _require_preset(preset, rec)
    generate_config(slp_path, output_path=output, stats=stats, recommendation=rec,
                    max_epochs=max_epochs, preset=preset)
    echo(json.dumps({
        "pipeline": rec.pipeline.pipeline,
        "reason": rec.pipeline.reason,
        "recommendation": rec.summary(),
        "preset": preset,
        "output": output,
    }, indent=2))


def _group_help() -> str:
    lines = [f"Usage: {PROG} [OPTIONS] COMMAND [ARGS]...", "",
             "  sleap-nn-tpu-torch: animal pose estimation on the GPU "
             "(train / predict / track / eval).", "",
             "Options:", "  --version  Show the version and exit.",
             "  --help     Show this message and exit.", "", "Commands:"]
    shown = [c for c in COMMANDS.values() if not c.hidden]
    width = max(len(c.name) for c in shown)
    for c in sorted(shown, key=lambda c: c.name):
        lines.append(f"  {c.name:<{width}}  {c.help.splitlines()[0] if c.help else ''}")
    return "\n".join(lines)


def _main(argv: List[str]) -> int:
    if not argv:
        echo(_group_help())
        return 2
    if argv[0] in ("-h", "--help"):
        echo(_group_help())
        return 0
    if argv[0] == "--version":
        echo(f"{PROG}, version {VERSION}")
        return 0
    cmd = COMMANDS.get(argv[0])
    if cmd is None:
        raise UsageError(f"No such command {argv[0]!r}.")
    result = cmd.fn(**cmd.parse(argv[1:]))
    return result if isinstance(result, int) else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Run one command; returns the exit code (2 for a usage error).
    Errors of the run itself propagate, as in the JAX command."""
    _setup_logging()
    try:
        return _main(list(sys.argv[1:] if argv is None else argv))
    except UsageError as e:
        echo(f"Error: {e}", err=True)
        return 2
    except SystemExit as e:  # argparse: --help (0) and usage errors (2)
        return e.code if isinstance(e.code, int) else (0 if e.code is None else 1)


if __name__ == "__main__":
    sys.exit(main())
