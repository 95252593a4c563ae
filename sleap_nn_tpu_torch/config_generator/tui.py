"""Interactive config generator: a curses front end, and plain prompts
where stdin or stdout is not a terminal.

Port of ``sleap_nn_tpu/config_generator/tui.py``. Four screens:

1. **Load**: the dataset's statistics and the recommendation's reasons.
2. **Model select**: pipeline and backbone.
3. **Configure**: every knob of the recommendation, each validated, in
   collapsible sections with sliders, and a memory gauge
   (``config_generator/memory.py``) recomputed on every change.
4. **Confirm**: a YAML preview and the memory summary; save or go back.

Both front ends run the analyzer, recommender and generator that
``config --auto`` runs. ``curses`` is imported only inside the functions
that draw.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Callable, List, Optional

PIPELINES = [
    "topdown", "bottomup", "single_instance", "centroid",
    "multi_class_topdown", "multi_class_bottomup",
]
BACKBONES = ["unet", "convnext", "swint"]
# The gauge's budget: the memory of the card the port runs on (NVIDIA H100
# 80GB HBM3, 700.00 W power limit), where no card is present to ask.
DEVICE_BUDGET_GB = 80.0


def _device_budget_gb() -> float:
    """The first CUDA device's memory in GB, else ``DEVICE_BUDGET_GB``."""
    import torch

    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory / 1e9
    return DEVICE_BUDGET_GB


def _analyze(slp_path: str):
    from sleap_nn_tpu_torch.config_generator import analyze_slp, recommend_config

    stats = analyze_slp(slp_path)
    rec = recommend_config(stats)
    return stats, rec


def _stats_lines(stats) -> List[str]:
    return [
        f"frames: {stats.num_labeled_frames}   videos: {stats.num_videos}",
        f"image: {stats.max_width}x{stats.max_height}x{stats.num_channels}",
        f"skeleton: {stats.num_nodes} nodes / {stats.num_edges} edges",
        f"instances/frame: avg {stats.avg_instances_per_frame:.2f} "
        f"max {stats.max_instances_per_frame}",
        f"bbox: avg {stats.avg_bbox_size:.0f} px "
        f"(diag {stats.avg_bbox_diagonal:.0f})",
    ]


def _pow2(v) -> bool:
    v = int(v)
    return v > 0 and (v & (v - 1)) == 0


class _Field:
    """One editable knob: choices cycle, free fields cast + validate.

    ``slider=(lo, hi, step)`` additionally makes ←/→ step the value within
    bounds and renders a slider bar in the curses front end (reference
    tui/app.py slider widgets); text entry via ``e`` still applies the
    caster + validator, so sliders never lose the free-entry path.
    """

    def __init__(self, name: str, value, choices: Optional[List] = None,
                 caster=str, reason: str = "",
                 validate: Optional[Callable] = None,
                 slider: Optional[tuple] = None):
        self.name = name
        self.value = value
        self.choices = choices
        self.caster = caster
        self.reason = reason
        self.validate = validate
        self.slider = slider
        self.error: Optional[str] = None

    def cycle(self, direction: int):
        if self.choices:
            i = self.choices.index(self.value) if self.value in self.choices else 0
            self.value = self.choices[(i + direction) % len(self.choices)]
            self.error = None
        elif self.slider:
            lo, hi, step = self.slider
            new = float(self.value) + direction * step
            new = min(float(hi), max(float(lo), new))
            if isinstance(step, int) and isinstance(lo, int):
                new = int(round(new))
            else:
                # quantize to the step grid so repeated arrows stay clean
                new = round(new, 6)
            self.value = new
            self.error = None

    def slider_bar(self, width: int = 12) -> str:
        lo, hi, _ = self.slider
        span = float(hi) - float(lo)
        frac = (float(self.value) - float(lo)) / span if span > 0 else 0.0
        frac = min(1.0, max(0.0, frac))
        pos = int(round(frac * (width - 1)))
        return "[" + "-" * pos + "#" + "-" * (width - 1 - pos) + "]"

    def set_text(self, text: str) -> bool:
        try:
            value = self.caster(text)
        except (TypeError, ValueError):
            self.error = f"not a valid {self.caster.__name__}"
            return False
        if self.validate is not None:
            err = self.validate(value)
            if err:
                self.error = err
                return False
        self.value = value
        self.error = None
        return True


def _model_fields(rec) -> List[_Field]:
    return [
        _Field("pipeline", rec.pipeline.pipeline, choices=PIPELINES,
               reason=rec.pipeline.reason),
        _Field("backbone", rec.backbone, choices=BACKBONES,
               reason=rec.backbone_reason),
        _Field("variant", "tiny", choices=["tiny", "small", "base"],
               reason="ConvNeXt/SwinT size (ignored for UNet)"),
    ]


def _prob(name: str, default: float = 0.0, reason: str = "") -> _Field:
    return _Field(name, default, caster=float, reason=reason,
                  slider=(0.0, 1.0, 0.05),
                  validate=lambda v: None if 0 <= v <= 1
                  else "must be in [0, 1]")


def _config_fields(slp_path: str, stats, rec,
                   output_path: Optional[str] = None) -> List[_Field]:
    default_out = output_path or str(
        Path(slp_path).parent / f"{Path(slp_path).stem}_config.yaml"
    )
    anchor_choices = ["auto"] + [str(n) for n in (stats.node_names or [])]
    return [
        # targets
        _Field("sigma", rec.sigma, caster=float, reason=rec.sigma_reason,
               slider=(0.5, 10.0, 0.25),
               validate=lambda v: None if 0 < v <= 50 else "must be in (0, 50]"),
        _Field("scale", rec.scale, caster=float, reason=rec.scale_reason,
               slider=(0.05, 1.0, 0.05),
               validate=lambda v: None if 0 < v <= 2 else "must be in (0, 2]"),
        # backbone
        _Field("output_stride", 2, caster=int,
               validate=lambda v: None if _pow2(v) and v <= 32
               else "must be a power of 2 <= 32"),
        _Field("max_stride", rec.max_stride, caster=int,
               validate=lambda v: None if _pow2(v) and 4 <= v <= 128
               else "must be a power of 2 in [4, 128]"),
        _Field("filters", 32, caster=int, slider=(4, 512, 4),
               validate=lambda v: None if 4 <= v <= 512 else "must be in [4, 512]"),
        _Field("filters_rate", 1.5, caster=float, slider=(1.0, 4.0, 0.25),
               validate=lambda v: None if 1.0 <= v <= 4.0 else "must be in [1, 4]"),
        # heads (pipeline-dependent)
        _Field("anchor_part", "auto", choices=anchor_choices,
               reason="crop anchor node (topdown)"),
        _Field("crop_size", 0, caster=int,
               reason="0 = auto from animal size",
               validate=lambda v: None if v == 0 or 16 <= v <= 4096
               else "0 (auto) or [16, 4096]"),
        _Field("pafs_output_stride", 4, caster=int,
               reason="PAF head stride (coarser = faster grouping)",
               validate=lambda v: None if _pow2(v) and v <= 32
               else "must be a power of 2 <= 32"),
        # preprocessing
        _Field("grayscale", "on" if stats.num_channels == 1 else "off",
               choices=["on", "off"], reason="convert frames to 1 channel"),
        _Field("validation_fraction", 0.1, caster=float,
               slider=(0.05, 0.5, 0.05),
               validate=lambda v: None if 0 < v < 1 else "must be in (0, 1)"),
        # training
        _Field("batch_size", rec.batch_size, caster=int,
               reason=rec.batch_size_reason, slider=(1, 256, 1),
               validate=lambda v: None if v >= 1 else "must be >= 1"),
        _Field("max_epochs", 100, caster=int,
               validate=lambda v: None if v >= 1 else "must be >= 1"),
        _Field("learning_rate", 1e-4, caster=float,
               validate=lambda v: None if 0 < v <= 1 else "must be in (0, 1]"),
        # augmentation
        _Field("augmentation", "on", choices=["on", "off"]),
        _Field("rotation", float(rec.rotation[1]), caster=float,
               reason=rec.rotation_reason, slider=(0.0, 180.0, 5.0),
               validate=lambda v: None if 0 <= v <= 180 else "must be in [0, 180]"),
        _Field("aug_scale_min", 0.9, caster=float, slider=(0.5, 1.0, 0.05),
               validate=lambda v: None if 0 < v <= 1 else "must be in (0, 1]"),
        _Field("aug_scale_max", 1.1, caster=float, slider=(1.0, 2.0, 0.05),
               validate=lambda v: None if 1 <= v <= 4 else "must be in [1, 4]"),
        _prob("affine_p", 0.5, "chance of rotation+scale+translate"),
        _prob("flip_p", 0.0, "horizontal flip (needs symmetric skeleton)"),
        _prob("contrast_p"),
        _prob("brightness_p"),
        _prob("noise_p", 0.0, "gaussian pixel noise"),
        _prob("erase_p", 0.0, "random erasing"),
        _prob("mixup_p", 0.0, "sample mixing"),
        _prob("rotation_p", 1.0, "chance the affine draw rotates"),
        _prob("scale_p", 1.0, "chance the affine draw scales"),
        _prob("translate_p", 0.0, "chance the affine draw translates"),
        _Field("translate_frac", 0.05, caster=float,
               reason="max translate as a fraction of image size",
               slider=(0.0, 0.5, 0.01),
               validate=lambda v: None if 0 <= v <= 0.5
               else "must be in [0, 0.5]"),
        _Field("noise_std", 0.02, caster=float,
               reason="gaussian noise sigma (normalized pixels)",
               slider=(0.0, 0.5, 0.01),
               validate=lambda v: None if 0 <= v <= 1 else "must be in [0, 1]"),
        _Field("contrast_min", 0.5, caster=float, slider=(0.0, 1.0, 0.05),
               validate=lambda v: None if 0 <= v <= 1 else "must be in [0, 1]"),
        _Field("contrast_max", 2.0, caster=float, slider=(1.0, 4.0, 0.1),
               validate=lambda v: None if 1 <= v <= 4 else "must be in [1, 4]"),
        _Field("brightness_min", 0.8, caster=float, slider=(0.0, 1.0, 0.05),
               validate=lambda v: None if 0 <= v <= 1 else "must be in [0, 1]"),
        _Field("brightness_max", 1.2, caster=float, slider=(1.0, 3.0, 0.05),
               validate=lambda v: None if 1 <= v <= 3 else "must be in [1, 3]"),
        # trainer
        _Field("optimizer", "adam", choices=["adam", "adamw"],
               reason="optimizer"),
        _Field("amsgrad", "off", choices=["off", "on"],
               reason="AMSGrad variant (adam only)"),
        _Field("scheduler", "none",
               choices=["none", "step_lr", "reduce_on_plateau",
                        "cosine_warmup", "linear_warmup_decay"],
               reason="learning-rate schedule (default: constant LR, "
                      "matching config-generate)"),
        _Field("early_stop_patience", 10, caster=int,
               reason="epochs without val improvement before stop; 0 = off",
               validate=lambda v: None if v >= 0 else "must be >= 0"),
        _Field("seed", 42, caster=int, reason="training RNG seed",
               validate=lambda v: None if v >= 0 else "must be >= 0"),
        _Field("run_name", "", reason="checkpoint run directory name"),
        _Field("save_ckpt", "off", choices=["off", "on"],
               reason="write best/last checkpoints"),
        _Field("use_wandb", "off", choices=["off", "on"],
               reason="log to Weights & Biases"),
        _Field("ohkm", "off", choices=["off", "on"],
               reason="online hard keypoint mining loss"),
        _Field("ohkm_ratio", 2.0, caster=float, slider=(1.0, 10.0, 0.5),
               reason="hard:easy loss ratio (when OHKM on)",
               validate=lambda v: None if v >= 1 else "must be >= 1"),
        # tiling
        _Field("tiling", "off", choices=["off", "on"],
               reason="train/infer on tiles of large images"),
        _Field("tile_size", 512, caster=int,
               validate=lambda v: None if 64 <= v <= 4096
               else "must be in [64, 4096]"),
        _Field("tile_overlap", 64, caster=int,
               validate=lambda v: None if 0 <= v <= 2048
               else "must be in [0, 2048]"),
        # output
        _Field("output", default_out),
    ]


class _Section:
    """A collapsible group of fields."""

    def __init__(self, title: str, fields: List[_Field],
                 collapsed: bool = False):
        self.title = title
        self.fields = fields
        self.collapsed = collapsed

    def marker(self) -> str:
        return "[+]" if self.collapsed else "[-]"


#: pipelines whose stage 2 crops around an anchored instance
_TOPDOWN_PIPELINES = ("topdown", "multi_class_topdown")
#: pipelines with a PAF grouping head
_PAF_PIPELINES = ("bottomup", "multi_class_bottomup")


def _config_sections(
    config_fields: List[_Field],
    pipeline: str = "topdown",
    backbone: str = "unet",
) -> List[_Section]:
    """Per-model-type field groups (reference tui/app.py per-type screens).

    The heads section only shows the knobs the chosen pipeline has
    (anchor/crop for topdown families, PAF stride for bottomup families),
    and UNet width knobs hide for preset encoders.
    """
    by = {f.name: f for f in config_fields}
    backbone_fields = [by["output_stride"], by["max_stride"]]
    if backbone == "unet":
        backbone_fields += [by["filters"], by["filters_rate"]]
    head_fields: List[_Field] = []
    if pipeline in _TOPDOWN_PIPELINES:
        head_fields += [by["anchor_part"], by["crop_size"]]
    if pipeline in _PAF_PIPELINES:
        head_fields += [by["pafs_output_stride"]]
    sections = [
        _Section("targets", [by["sigma"], by["scale"]]),
        _Section("backbone", backbone_fields),
    ]
    if head_fields:
        sections.append(_Section("heads", head_fields))
    sections += [
        _Section("preprocessing", [by["grayscale"],
                                   by["validation_fraction"]]),
        _Section("training", [by["batch_size"], by["max_epochs"],
                              by["learning_rate"]]),
        _Section("augmentation", [
            by["augmentation"], by["rotation"],
            by["aug_scale_min"], by["aug_scale_max"], by["affine_p"],
            by["rotation_p"], by["scale_p"], by["translate_p"],
            by["translate_frac"],
            by["flip_p"], by["contrast_p"], by["contrast_min"],
            by["contrast_max"], by["brightness_p"], by["brightness_min"],
            by["brightness_max"], by["noise_p"], by["noise_std"],
            by["erase_p"], by["mixup_p"],
        ], collapsed=True),
        _Section("trainer", [
            by["optimizer"], by["amsgrad"], by["scheduler"],
            by["early_stop_patience"], by["seed"], by["run_name"],
            by["save_ckpt"], by["use_wandb"], by["ohkm"], by["ohkm_ratio"],
        ], collapsed=True),
        _Section("tiling", [by["tiling"], by["tile_size"],
                            by["tile_overlap"]], collapsed=True),
        _Section("output", [by["output"]]),
    ]
    return sections


def _memory_gauge(stats, model_fields: List[_Field],
                  config_fields: List[_Field]) -> str:
    """One-line live memory gauge from the estimator (reference memory gauge)."""
    from sleap_nn_tpu_torch.config_generator.memory import estimate_memory

    vals = {f.name: f.value for f in model_fields + config_fields}
    try:
        est = estimate_memory(
            height=stats.max_height, width=stats.max_width,
            channels=stats.num_channels,
            batch_size=int(vals["batch_size"]),
            filters=int(vals["filters"]),
            filters_rate=float(vals["filters_rate"]),
            max_stride=int(vals["max_stride"]),
            output_stride=int(vals["output_stride"]),
            scale=float(vals["scale"]),
            n_heads_channels=max(stats.num_nodes, 1),
        )
    except Exception:
        return "memory: n/a"
    total = est.total_device_gb
    budget = _device_budget_gb()
    frac = min(total / budget, 1.0)
    bar = "#" * int(round(frac * 20))
    flag = "  OVER BUDGET!" if total > budget else ""
    return (
        f"memory [{bar:<20}] {total:.2f}/{budget:.0f} GB "
        f"(par {est.params_gb:.2f} + act {est.activations_gb:.2f} "
        f"+ opt {est.optimizer_gb:.2f}){flag}"
    )


def _apply_and_save(slp_path: str, stats, rec, model_fields: List[_Field],
                    config_fields: List[_Field]) -> str:
    from sleap_nn_tpu_torch.config import apply_overrides
    from sleap_nn_tpu_torch.config_generator import generate_config

    vals = {f.name: f.value for f in model_fields + config_fields}
    rec.pipeline.pipeline = vals["pipeline"]
    rec.backbone = vals["backbone"]
    rec.sigma = float(vals["sigma"])
    rec.scale = float(vals["scale"])
    rec.batch_size = int(vals["batch_size"])
    rec.max_stride = int(vals["max_stride"])
    rot = abs(float(vals["rotation"]))
    rec.rotation = (-rot, rot)
    out = str(vals["output"])
    cfg = generate_config(slp_path, output_path=None, stats=stats,
                          recommendation=rec, max_epochs=int(vals["max_epochs"]))
    bb = rec.backbone
    os_ = int(vals["output_stride"])
    over = {
        f"model_config.backbone_config.{bb}.output_stride": os_,
    }
    if bb == "unet":
        over[f"model_config.backbone_config.{bb}.filters"] = int(vals["filters"])
        over[f"model_config.backbone_config.{bb}.filters_rate"] = float(
            vals["filters_rate"]
        )
    elif bb in ("convnext", "swint"):
        over[f"model_config.backbone_config.{bb}.model_type"] = str(
            vals.get("variant", "tiny")
        )
    apply_overrides(cfg, over)
    # Keep head strides consistent with the decoder's finest output.
    hc = cfg.model_config.head_configs
    wrapper = getattr(hc, hc.which())
    import dataclasses as _dc

    for f_ in _dc.fields(wrapper):
        leaf = getattr(wrapper, f_.name)
        if leaf is not None and hasattr(leaf, "output_stride"):
            if f_.name == "pafs":
                leaf.output_stride = max(
                    os_, int(vals.get("pafs_output_stride",
                                      leaf.output_stride))
                )
            else:
                leaf.output_stride = os_
        if (leaf is not None and hasattr(leaf, "anchor_part")
                and str(vals.get("anchor_part", "auto")) != "auto"):
            leaf.anchor_part = str(vals["anchor_part"])
    # Heads / preprocessing knobs.
    pipeline = rec.pipeline.pipeline
    if pipeline in _TOPDOWN_PIPELINES and int(vals.get("crop_size", 0)) > 0:
        cfg.data_config.preprocessing.crop_size = int(vals["crop_size"])
    cfg.data_config.preprocessing.ensure_grayscale = (
        vals.get("grayscale", "on") == "on"
    )
    cfg.data_config.preprocessing.ensure_rgb = not (
        cfg.data_config.preprocessing.ensure_grayscale
    ) and stats.num_channels == 3
    cfg.data_config.validation_fraction = float(
        vals.get("validation_fraction", 0.1)
    )
    cfg.trainer_config.optimizer.lr = float(vals.get("learning_rate", 1e-4))
    # Trainer knobs.
    from sleap_nn_tpu_torch.config.trainer_config import (
        CosineAnnealingWarmupConfig, LinearWarmupLinearDecayConfig,
        LRSchedulerConfig, ReduceLROnPlateauConfig, StepLRConfig,
    )

    tc = cfg.trainer_config
    tc.optimizer_name = str(vals.get("optimizer", "adam"))
    tc.optimizer.amsgrad = vals.get("amsgrad", "off") == "on"
    sched = str(vals.get("scheduler", "none"))
    max_ep = int(vals.get("max_epochs", 100))
    if sched == "none":
        tc.lr_scheduler = LRSchedulerConfig()
    elif sched == "step_lr":
        tc.lr_scheduler = LRSchedulerConfig(step_lr=StepLRConfig())
    elif sched == "reduce_on_plateau":
        tc.lr_scheduler = LRSchedulerConfig(
            reduce_lr_on_plateau=ReduceLROnPlateauConfig())
    elif sched == "cosine_warmup":
        tc.lr_scheduler = LRSchedulerConfig(
            cosine_annealing_warmup=CosineAnnealingWarmupConfig(
                max_epochs=max_ep))
    elif sched == "linear_warmup_decay":
        tc.lr_scheduler = LRSchedulerConfig(
            linear_warmup_linear_decay=LinearWarmupLinearDecayConfig(
                max_epochs=max_ep))
    patience = int(vals.get("early_stop_patience", 10))
    tc.early_stopping.stop_training_on_plateau = patience > 0
    if patience > 0:
        tc.early_stopping.patience = patience
    tc.seed = int(vals.get("seed", tc.seed or 0))
    if str(vals.get("run_name", "")).strip():
        tc.run_name = str(vals["run_name"]).strip()
    tc.save_ckpt = vals.get("save_ckpt", "off") == "on"
    tc.use_wandb = vals.get("use_wandb", "off") == "on"
    tc.online_hard_keypoint_mining.online_mining = (
        vals.get("ohkm", "off") == "on")
    tc.online_hard_keypoint_mining.hard_to_easy_ratio = float(
        vals.get("ohkm_ratio", 2.0))
    # Augmentation detail.
    if vals["augmentation"] == "off":
        cfg.data_config.use_augmentations_train = False
        cfg.data_config.augmentation_config = None
    elif cfg.data_config.augmentation_config is not None:
        geo = cfg.data_config.augmentation_config.geometric
        inten = cfg.data_config.augmentation_config.intensity
        if geo is not None:
            geo.scale_min = float(vals.get("aug_scale_min", geo.scale_min))
            geo.scale_max = float(vals.get("aug_scale_max", geo.scale_max))
            geo.affine_p = float(vals.get("affine_p", geo.affine_p))
            geo.rotation_p = float(vals.get("rotation_p", geo.rotation_p))
            geo.scale_p = float(vals.get("scale_p", geo.scale_p))
            geo.translate_p = float(vals.get("translate_p", geo.translate_p))
            tf = float(vals.get("translate_frac", geo.translate_width))
            geo.translate_width = tf
            geo.translate_height = tf
            geo.flip_p = float(vals.get("flip_p", geo.flip_p))
            geo.erase_p = float(vals.get("erase_p", geo.erase_p))
            geo.mixup_p = float(vals.get("mixup_p", geo.mixup_p))
        if inten is not None:
            inten.contrast_p = float(vals.get("contrast_p", inten.contrast_p))
            inten.contrast_min = float(
                vals.get("contrast_min", inten.contrast_min))
            inten.contrast_max = float(
                vals.get("contrast_max", inten.contrast_max))
            inten.brightness_p = float(
                vals.get("brightness_p", inten.brightness_p)
            )
            inten.brightness_min = float(
                vals.get("brightness_min", inten.brightness_min))
            inten.brightness_max = float(
                vals.get("brightness_max", inten.brightness_max))
            inten.gaussian_noise_p = float(
                vals.get("noise_p", inten.gaussian_noise_p)
            )
            inten.gaussian_noise_std = float(
                vals.get("noise_std", inten.gaussian_noise_std))
    # Tiling.
    if vals.get("tiling", "off") == "on":
        tiling = cfg.data_config.preprocessing.tiling
        tiling.enabled = True
        tiling.tile_size = int(vals.get("tile_size", 512))
        tiling.overlap = int(vals.get("tile_overlap", 64))
    cfg.save_yaml(out)
    return out


def _yaml_preview(slp_path, stats, rec, model_fields, config_fields,
                  n_lines: int = 14) -> List[str]:
    """First lines of the YAML that would be saved (confirm screen)."""
    import copy

    try:
        import tempfile

        with tempfile.TemporaryDirectory() as td:
            tmp_out = str(Path(td) / "preview.yaml")
            saved_fields = copy.deepcopy(config_fields)
            for f in saved_fields:
                if f.name == "output":
                    f.value = tmp_out
            _apply_and_save(slp_path, stats, copy.deepcopy(rec),
                            copy.deepcopy(model_fields), saved_fields)
            text = Path(tmp_out).read_text().splitlines()
        return text[:n_lines] + (["..."] if len(text) > n_lines else [])
    except Exception as e:
        return [f"(preview unavailable: {e})"]


# --------------------------------------------------------------------------- #
# curses front end
# --------------------------------------------------------------------------- #


def _safe_addstr(stdscr, y, x, s, attr=0):
    """addstr that never crashes on small windows (curses raises when a
    write touches the bottom-right cell or falls outside the screen)."""
    import curses

    try:
        maxy, maxx = stdscr.getmaxyx()
        if 0 <= y < maxy and x < maxx:
            stdscr.addstr(y, x, str(s)[: max(0, maxx - x - 1)], attr)
    except curses.error:
        pass


def _file_browser(stdscr, start: str) -> Optional[str]:
    """Minimal directory browser (reference tui/app.py file-browser screen).

    ↑/↓ move, Enter descends into a directory or selects a file, ``n``
    prompts for a new filename in the current directory (for output paths),
    ``q``/Esc cancels. Returns the chosen absolute path or None.
    """
    import curses

    cur = Path(start)
    if not cur.is_dir():
        cur = cur.parent if cur.parent.is_dir() else Path.cwd()
    sel = 0
    while True:
        try:
            entries = sorted(
                [p for p in cur.iterdir() if not p.name.startswith(".")],
                key=lambda p: (not p.is_dir(), p.name.lower()),
            )
        except OSError:
            entries = []
        items = [cur.parent] + entries  # row 0 = ".."
        sel = min(sel, len(items) - 1)
        stdscr.erase()
        _safe_addstr(stdscr, 0, 2, f"[browse] {cur}", curses.A_BOLD)
        _safe_addstr(stdscr, 1, 2,
                     "enter open/select · n new file here · q cancel",
                     curses.A_DIM)
        maxy = stdscr.getmaxyx()[0]
        visible = max(1, maxy - 5)
        top = max(0, sel - visible + 1)
        for i, p in enumerate(items[top:top + visible]):
            label = ".." if i + top == 0 else (
                p.name + ("/" if p.is_dir() else ""))
            attr = curses.A_REVERSE if i + top == sel else curses.A_NORMAL
            _safe_addstr(stdscr, 2 + i, 4, label, attr)
        stdscr.refresh()
        ch = stdscr.getch()
        if ch == 12:  # ctrl-L: force a full repaint
            stdscr.redrawwin()
            continue
        if ch in (ord("q"), 27):
            return None
        if ch == curses.KEY_UP:
            sel = (sel - 1) % len(items)
        elif ch == curses.KEY_DOWN:
            sel = (sel + 1) % len(items)
        elif ch == ord("n"):
            curses.curs_set(1)
            _safe_addstr(stdscr, maxy - 2, 2, "filename: ")
            curses.echo()
            try:
                name = stdscr.getstr(maxy - 2, 12).decode()
            except curses.error:
                name = ""
            curses.noecho()
            curses.curs_set(0)
            if name:
                return str(cur / name)
        elif ch in (ord("\n"), curses.KEY_ENTER, 10):
            chosen = items[sel]
            if chosen.is_dir():
                cur = chosen.resolve()
                sel = 0
            else:
                return str(chosen)


def _curses_flow(stdscr, slp_path: str, stats, rec,
                 output_path: Optional[str] = None):
    import curses

    curses.curs_set(0)
    model_fields = _model_fields(rec)
    config_fields = _config_fields(slp_path, stats, rec, output_path)
    sections = _config_sections(config_fields)
    screen = 0  # 0 load, 1 model select, 2 configure, 3 confirm

    def rebuild_sections():
        # Per-model-type field groups: the configure screen shows the knobs
        # of the CURRENT pipeline/backbone selection, preserving collapse
        # state across rebuilds.
        nonlocal sections
        collapsed = {s.title: s.collapsed for s in sections}
        mv = {f.name: f.value for f in model_fields}
        sections = _config_sections(
            config_fields, pipeline=str(mv.get("pipeline", "topdown")),
            backbone=str(mv.get("backbone", "unet")),
        )
        for s in sections:
            if s.title in collapsed:
                s.collapsed = collapsed[s.title]

    def header(title, extra=""):
        stdscr.erase()
        _safe_addstr(stdscr, 0, 2,
                     f"sleap-nn-tpu-torch config — {Path(slp_path).name}"
                     f"  [{title}]", curses.A_BOLD)
        if extra:
            _safe_addstr(stdscr, 1, 2, extra, curses.A_DIM)

    def render_field(row, f, selected):
        attr = curses.A_REVERSE if selected else curses.A_NORMAL
        if f.slider:
            text = f"{f.name:<14} {f.slider_bar()} {f.value}"
        else:
            text = f"{f.name:<14} {f.value}"
        _safe_addstr(stdscr, row, 4, text, attr)
        note = f.error or (f.reason if selected else "")
        if note:
            _safe_addstr(stdscr, row, 52, f"({note})"[:26],
                         curses.A_BOLD if f.error else curses.A_DIM)

    def edit_field(f, prompt_row):
        curses.curs_set(1)
        _safe_addstr(stdscr, prompt_row, 2, f"{f.name}: ")
        curses.echo()
        try:
            text = stdscr.getstr(prompt_row, 4 + len(f.name)).decode()
        except curses.error:
            text = ""
        curses.noecho()
        curses.curs_set(0)
        if text:
            f.set_text(text)

    def field_form(fields, title, hint):
        """Flat field list (model-select screen)."""
        sel = 0
        while True:
            header(title, hint)
            row = 2
            for line in _stats_lines(stats):
                _safe_addstr(stdscr, row, 4, line)
                row += 1
            row += 1
            for i, f in enumerate(fields):
                render_field(row, f, i == sel)
                row += 1
            _safe_addstr(stdscr, row + 3, 2,
                         "up/down select · left/right cycle · e edit · "
                         "n next · b back · q quit", curses.A_DIM)
            stdscr.refresh()
            ch = stdscr.getch()
            if ch == 12:  # ctrl-L: force a full repaint
                stdscr.redrawwin()
                continue
            if ch in (ord("q"), 27):
                return "quit"
            if ch == ord("n"):
                return "next"
            if ch == ord("b"):
                return "back"
            if ch == curses.KEY_UP:
                sel = (sel - 1) % len(fields)
            elif ch == curses.KEY_DOWN:
                sel = (sel + 1) % len(fields)
            elif ch in (curses.KEY_LEFT, curses.KEY_RIGHT):
                fields[sel].cycle(1 if ch == curses.KEY_RIGHT else -1)
            elif ch in (ord("e"), ord("\n"), curses.KEY_ENTER, 10):
                if fields[sel].choices:
                    fields[sel].cycle(1)
                    continue
                edit_field(fields[sel], row + 2)

    def section_form(title, hint):
        """Configure screen: collapsible sections + sliders + live gauge."""
        sel = 0
        while True:
            # Entry list mixes section headers and (visible) fields so one
            # cursor walks both: ("hdr", section) | ("field", field).
            entries = []
            for sec in sections:
                entries.append(("hdr", sec))
                if not sec.collapsed:
                    entries.extend(("field", f) for f in sec.fields)
            sel = min(sel, len(entries) - 1)
            header(title, hint)
            row = 2
            for i, (kind, obj) in enumerate(entries):
                if kind == "hdr":
                    attr = curses.A_BOLD | (
                        curses.A_REVERSE if i == sel else 0)
                    _safe_addstr(stdscr, row, 2,
                                 f"{obj.marker()} {obj.title}", attr)
                else:
                    render_field(row, obj, i == sel)
                row += 1
            _safe_addstr(stdscr, row + 1, 4,
                         _memory_gauge(stats, model_fields, config_fields))
            _safe_addstr(stdscr, row + 3, 2,
                         "up/down select · left/right slide/cycle · e edit · "
                         "f browse · enter toggle · n next · b back · q quit",
                         curses.A_DIM)
            stdscr.refresh()
            ch = stdscr.getch()
            if ch == 12:  # ctrl-L: force a full repaint
                stdscr.redrawwin()
                continue
            kind, obj = entries[sel]
            if ch in (ord("q"), 27):
                return "quit"
            if ch == ord("n"):
                return "next"
            if ch == ord("b"):
                return "back"
            if ch == curses.KEY_UP:
                sel = (sel - 1) % len(entries)
            elif ch == curses.KEY_DOWN:
                sel = (sel + 1) % len(entries)
            elif kind == "hdr" and ch in (ord("\n"), curses.KEY_ENTER, 10,
                                          ord(" "), curses.KEY_LEFT,
                                          curses.KEY_RIGHT):
                obj.collapsed = not obj.collapsed
            elif kind == "field":
                if ch in (curses.KEY_LEFT, curses.KEY_RIGHT):
                    obj.cycle(1 if ch == curses.KEY_RIGHT else -1)
                elif ch == ord("f") and obj.caster is str:
                    chosen = _file_browser(stdscr, str(obj.value))
                    if chosen:
                        obj.set_text(chosen)
                elif ch in (ord("e"), ord("\n"), curses.KEY_ENTER, 10):
                    if obj.choices:
                        obj.cycle(1)
                        continue
                    edit_field(obj, row + 2)

    while True:
        if screen == 0:
            header("load", "n continue · q quit")
            row = 2
            for line in _stats_lines(stats):
                _safe_addstr(stdscr, row, 4, line)
                row += 1
            _safe_addstr(stdscr, row + 1, 4,
                          f"recommended: {rec.pipeline.pipeline} / {rec.backbone}")
            _safe_addstr(stdscr, row + 2, 6, rec.pipeline.reason[:70], curses.A_DIM)
            stdscr.refresh()
            ch = stdscr.getch()
            if ch == 12:
                stdscr.redrawwin()
                continue
            if ch in (ord("q"), 27):
                return None
            if ch in (ord("n"), ord("\n"), 10):
                screen = 1
        elif screen == 1:
            action = field_form(model_fields, "model select",
                                "choose pipeline + backbone")
            if action == "quit":
                return None
            screen = 2 if action == "next" else 0
        elif screen == 2:
            rebuild_sections()
            action = section_form("configure",
                                  "edit knobs; gauge updates live")
            if action == "quit":
                return None
            screen = 3 if action == "next" else 1
        else:
            # Preview computed ONCE per entry into the confirm screen (the
            # fields are frozen here; recomputing per keypress would re-run
            # the whole config-generation pipeline on every getch).
            preview = _yaml_preview(slp_path, stats, rec, model_fields,
                                    config_fields)
            gauge = _memory_gauge(stats, model_fields, config_fields)
            while True:
                header("confirm", "s save · b back · q quit")
                row = 2
                for line in preview:
                    _safe_addstr(stdscr, row, 4, line[:74])
                    row += 1
                _safe_addstr(stdscr, row + 1, 4, gauge)
                stdscr.refresh()
                ch = stdscr.getch()
                if ch == 12:
                    stdscr.redrawwin()
                    continue
                if ch in (ord("q"), 27):
                    return None
                if ch == ord("b"):
                    screen = 2
                    break
                if ch == ord("s"):
                    return _apply_and_save(slp_path, stats, rec, model_fields,
                                           config_fields)


def _prompt_flow(slp_path: str, stats, rec,
                 output_path: Optional[str] = None) -> Optional[str]:
    """Plain-prompt fallback when stdin/stdout is not a terminal.

    Same four-stage flow, linearized; empty input keeps the default, invalid
    input re-prompts with the validation message.
    """
    model_fields = _model_fields(rec)
    config_fields = _config_fields(slp_path, stats, rec, output_path)
    print(f"sleap-nn-tpu-torch config — {Path(slp_path).name}")
    for line in _stats_lines(stats):
        print("  " + line)
    print(f"\n[model select]  recommended: {rec.pipeline.pipeline} / {rec.backbone}")

    def ask(f: _Field):
        suffix = f" [{'/'.join(map(str, f.choices))}]" if f.choices else ""
        reason = f"  ({f.reason})" if f.reason else ""
        while True:
            try:
                raw = input(f"{f.name}{suffix} [{f.value}]{reason}: ").strip()
            except EOFError:
                return
            if not raw:
                return
            if f.choices:
                if raw in [str(c) for c in f.choices]:
                    f.value = raw
                    return
                print(f"  invalid choice; keeping {f.value!r}")
                return
            if f.set_text(raw):
                return
            print(f"  {f.error}; try again or press enter to keep {f.value!r}")

    for f in model_fields:
        ask(f)
    print("\n[configure]")
    mv = {f.name: f.value for f in model_fields}
    sections = _config_sections(
        config_fields, pipeline=str(mv.get("pipeline", "topdown")),
        backbone=str(mv.get("backbone", "unet")),
    )
    for sec in sections:
        print(f"  -- {sec.title} --")
        for f in sec.fields:
            ask(f)
            if f.name in ("batch_size", "filters", "scale", "max_stride"):
                print("  " + _memory_gauge(stats, model_fields, config_fields))
    print("\n[confirm]")
    print("  " + _memory_gauge(stats, model_fields, config_fields))
    try:
        confirm = input("save? [Y/n]: ").strip().lower()
    except EOFError:
        confirm = ""
    if confirm in ("n", "no"):
        return None
    return _apply_and_save(slp_path, stats, rec, model_fields, config_fields)


def launch_tui(slp_path: Optional[str],
               output_path: Optional[str] = None) -> Optional[str]:
    """Run the interactive config generator; returns the saved YAML path."""
    if not slp_path:
        raise SystemExit("config: SLP_PATH is required for interactive mode.")
    stats, rec = _analyze(slp_path)
    if sys.stdin.isatty() and sys.stdout.isatty():
        import curses

        out = curses.wrapper(_curses_flow, slp_path, stats, rec, output_path)
    else:
        out = _prompt_flow(slp_path, stats, rec, output_path)
    if out:
        print(f"Saved config to: {out}")
    return out
