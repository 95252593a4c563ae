"""Export implementation: wrapper building, serialization, verification.

Port of ``sleap_nn_tpu/export/exporter.py``. The artifact is
``torch.export.save`` of the traced wrapper, ``model.pt2``: one program
that takes a uint8 ``(B, H, W, C)`` batch of the baked shape and returns
the model type's outputs, the preprocessing, the forward and the peak
finding (and for bottom-up the PAF line scores) inside it. The UNet's
double-conv blocks trace as the fused kernel's registered operator, the
peak finding as kernel 2's and the line scores as kernel 3's
(``ops/library.py``), so the loaded program launches the kernels on the
card and runs their plain versions on the CPU. The JAX package's formats
(StableHLO, TF SavedModel) have no counterpart here and are refused.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
from pathlib import Path
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from sleap_nn_tpu_torch.config import get_head_config
from sleap_nn_tpu_torch.inference.backends import maybe_fuse_convs, resolve_device
from sleap_nn_tpu_torch.inference.layers import (
    BottomUpMultiClassLayer,
    PostprocessConfig,
    PreprocessConfig,
    preprocess_images,
)
from sleap_nn_tpu_torch.inference.loaders import LoadedModel, load_model
from sleap_nn_tpu_torch.inference.paf_grouping import (
    PAFScorer,
    group_peaks_by_node,
    line_fractions,
    score_paf_lines_dense,
)
from sleap_nn_tpu_torch.inference.segmentation import BottomUpSegmentationLayer
from sleap_nn_tpu_torch.ops.peaks import find_global_peaks, find_local_peaks

FORMAT = "torch_export_pt2"
ARTIFACT = "model.pt2"
RUNTIMES = ("auto", "pt2")
_JAX_FORMATS = ("stablehlo", "savedmodel")


@dataclasses.dataclass
class ExportMetadata:
    """Exported-model metadata, with the JAX package's fields and JSON."""

    model_type: str
    input_shape: Tuple[int, ...]
    input_dtype: str
    output_names: Tuple[str, ...]
    peak_threshold: float
    skeleton_nodes: Tuple[str, ...]
    skeleton_edges: Tuple[Tuple[str, str], ...]
    artifact: str
    artifact_sha256: str
    format: str = FORMAT
    # The node that anchored crops / centroids in training.
    anchor_part: "Optional[str]" = None
    # Baked postprocessing beyond the threshold, so that the predict flow
    # can warn when a runtime flag differs from what the program does.
    refinement: "Optional[str]" = None
    max_peaks: "Optional[int]" = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=list)

    @classmethod
    def from_json(cls, text: str) -> "ExportMetadata":
        d = json.loads(text)
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls) if f.name in d})


def jax_format_refusal(what: str) -> ValueError:
    """The error for a JAX package export format, runtime or directory."""
    return ValueError(
        f"{what} is a format of the JAX package's export (StableHLO / TF SavedModel), "
        "which has no runtime on the GPU (no JAX, no TensorFlow); the port exports and "
        f"loads torch.export programs: --format pt2 / runtime 'pt2' ({ARTIFACT}). Export "
        "the model dir again with the port.")


def _anchor_part_from_config(config) -> "Optional[str]":
    """The trained anchor node, if any (centroid / centered-instance heads)."""
    hc = getattr(getattr(config, "model_config", None), "head_configs", None)
    for name in ("centroid", "centered_instance"):
        cm = getattr(getattr(hc, name, None), "confmaps", None)
        ap = getattr(cm, "anchor_part", None)
        if ap is not None:
            return ap
    return None


class _Backend(nn.Module):
    """One model's forward inside the exported program: the UNet's
    double-conv blocks fused, no gradients, bf16 in and f32 out with
    ``use_bf16`` (the live ``TorchBackend``'s policy)."""

    def __init__(self, model: nn.Module, use_bf16: bool, device: torch.device):
        super().__init__()
        model = maybe_fuse_convs(copy.deepcopy(model), True)
        self.model = model.to(device=device,
                              dtype=torch.bfloat16 if use_bf16 else torch.float32).eval()
        self.model.requires_grad_(False)
        self.use_bf16 = use_bf16
        self.device = device

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.use_bf16:
            x = x.to(torch.bfloat16)
        return {k: v.float() for k, v in self.model(x).items()}


class _Program(nn.Module):
    """The traced wrapper: ``fn(self, images)`` over the backends and the
    constant tensors (edge indices, line fractions) held as buffers."""

    def __init__(self, fn: Callable, backends: Dict[str, _Backend],
                 buffers: Optional[Dict[str, torch.Tensor]] = None):
        super().__init__()
        self.backends = nn.ModuleDict(backends)
        for name, value in (buffers or {}).items():
            self.register_buffer(name, value)
        self._fn = fn

    def forward(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self._fn(self, images)


def _const(value: float, b: int, device) -> torch.Tensor:
    """A float broadcast to ``(b,)`` f32, as ``jnp.broadcast_to``."""
    return torch.full((b,), float(value), dtype=torch.float32, device=device)


def _crop_input(pre_cfg, pre: PreprocessConfig) -> int:
    crop = pre_cfg.crop_size or 128
    crop = int(round(crop * pre.scale))
    return crop + (-crop) % pre.max_stride


def _build_wrapper(loaded: LoadedModel, peak_threshold: float, batch_size: int,
                   max_peaks: int, paf_knobs: dict = None, use_bf16: bool = False,
                   device="cuda"):
    """Normalize + forward + peaks of one model as a ``_Program``; returns
    ``(program, input_shape, output_names)``, as the JAX package's
    ``_build_wrapper`` returns its function."""
    device = resolve_device(device)
    pre_cfg = loaded.config.data_config.preprocessing
    pre = PreprocessConfig(
        ensure_rgb=pre_cfg.ensure_rgb,
        ensure_grayscale=pre_cfg.ensure_grayscale,
        max_height=pre_cfg.max_height,
        max_width=pre_cfg.max_width,
        scale=pre_cfg.scale,
        max_stride=loaded.backbone_config.max_stride,
    )
    backends = {"model": _Backend(loaded.model, use_bf16, device)}
    model_type = loaded.model_type
    head = get_head_config(loaded.config)
    h = pre.max_height or 256
    w = pre.max_width or 256
    c = 3 if pre_cfg.ensure_rgb else 1
    input_shape = (batch_size, h, w, c)
    buffers = None

    if model_type == "single_instance":
        stride = head.confmaps.output_stride

        def fn(self, images):
            x, eff = preprocess_images(pre, images)
            cms = self.backends["model"](x)["SingleInstanceConfmapsHead"]
            pts, vals = find_global_peaks(cms, peak_threshold, "integral")
            return {"pred_keypoints": pts * stride / (pre.scale * eff), "pred_peak_values": vals}

        outputs = ("pred_keypoints", "pred_peak_values")

    elif model_type == "centroid":
        stride = head.confmaps.output_stride

        def fn(self, images):
            x, eff = preprocess_images(pre, images)
            cms = self.backends["model"](x)["CentroidConfmapsHead"]
            pts, vals, _, valid = find_local_peaks(cms, peak_threshold, "integral",
                                                   max_peaks=max_peaks)
            return {"pred_centroids": pts * stride / (pre.scale * eff),
                    "centroid_vals": vals, "centroid_valid": valid}

        outputs = ("pred_centroids", "centroid_vals", "centroid_valid")

    elif model_type == "centered_instance":
        stride = head.confmaps.output_stride
        crop = _crop_input(pre_cfg, pre)
        input_shape = (batch_size, crop, crop, c)

        def fn(self, crops):
            x = crops.to(torch.float32) / 255.0
            cms = self.backends["model"](x)["CenteredInstanceConfmapsHead"]
            pts, vals = find_global_peaks(cms, peak_threshold, "integral")
            return {"pred_keypoints": pts * stride, "pred_peak_values": vals}

        outputs = ("pred_keypoints", "pred_peak_values")

    elif model_type == "bottomup":
        cm_stride = head.confmaps.output_stride
        scorer = PAFScorer(part_names=head.confmaps.part_names,
                           edges=[tuple(e) for e in head.pafs.edges],
                           pafs_stride=head.pafs.output_stride, **(paf_knobs or {}))
        # The scorer's device copies become buffers: constants of the graph.
        buffers = {
            "edge_inds": torch.tensor(scorer.edge_inds, dtype=torch.int32,
                                      device=device).reshape(-1, 2),
            "line_t": line_fractions(scorer.n_points, device=device),
        }

        def fn(self, images):
            x, eff = preprocess_images(pre, images)
            preds = self.backends["model"](x)
            pafs = preds["PartAffinityFieldsHead"]
            pts, vals, ch, valid = find_local_peaks(preds["MultiInstanceConfmapsHead"],
                                                    peak_threshold, "integral",
                                                    max_peaks=max_peaks)
            gp, gv, mask = group_peaks_by_node(pts * cm_stride, vals, ch, valid,
                                               scorer.n_nodes, scorer.k_per_node)
            scores = score_paf_lines_dense(
                pafs, gp, mask, self.edge_inds, n_line_points=scorer.n_points,
                pafs_stride=scorer.pafs_stride,
                max_edge_length_ratio=scorer.max_edge_length_ratio,
                dist_penalty_weight=scorer.dist_penalty_weight, t=self.line_t)
            return {"grouped_peaks": gp / (pre.scale * eff), "grouped_vals": gv,
                    "grouped_mask": mask, "paf_scores": scores}

        outputs = ("grouped_peaks", "grouped_vals", "grouped_mask", "paf_scores")

    elif model_type == "multi_class_bottomup":
        layer = BottomUpMultiClassLayer(
            backends["model"], pre, PostprocessConfig(peak_threshold=peak_threshold,
                                                      max_peaks=max_peaks),
            n_nodes=len(head.confmaps.part_names), n_classes=len(head.class_maps.classes),
            cm_output_stride=head.confmaps.output_stride,
            class_maps_output_stride=head.class_maps.output_stride, device=device)
        cm_grid_stride = head.class_maps.output_stride

        def fn(self, images):
            # The layer gathers each peak's class probabilities on the
            # device, so the program ships them, never the class maps.
            dev = layer.forward(images)
            b = images.shape[0]
            return {"points_grid": dev["points"], "rough": dev["rough"], "vals": dev["vals"],
                    "channels": dev["channels"], "valid": dev["valid"],
                    "class_probs": dev["peak_class_probs"],
                    "lift": _const(cm_grid_stride / (pre.scale * dev["eff_scale"]), b,
                                   images.device)}

        outputs = ("points_grid", "rough", "vals", "channels", "valid", "class_probs", "lift")

    elif model_type == "centered_instance_segmentation":
        crop = _crop_input(pre_cfg, pre)
        input_shape = (batch_size, crop, crop, c)

        def fn(self, crops):
            x = crops.to(torch.float32) / 255.0
            return {"seg_probs": self.backends["model"](x)["SegmentationHead"]}

        outputs = ("seg_probs",)

    elif model_type == "semantic_segmentation":

        def fn(self, images):
            x, eff = preprocess_images(pre, images)
            return {"fg": self.backends["model"](x)["SegmentationHead"],
                    "eff_scale": _const(eff, images.shape[0], images.device)}

        outputs = ("fg", "eff_scale")

    elif model_type == "bottomup_segmentation":
        layer = BottomUpSegmentationLayer(
            backends["model"], pre, PostprocessConfig(peak_threshold=peak_threshold),
            seg_output_stride=head.segmentation.output_stride,
            center_output_stride=head.center.output_stride,
            offsets_output_stride=head.offsets.output_stride,
            max_instances=max_peaks, device=device)

        def fn(self, images):
            out = layer.forward(images)
            # The live layer's device outputs, as the JAX program returns
            # them: eff_scale a scalar, orig_hw the frame's (H, W).
            out["eff_scale"] = torch.tensor(out["eff_scale"], dtype=torch.float32,
                                            device=images.device)
            out["orig_hw"] = torch.tensor(out["orig_hw"], device=images.device)
            return out

        outputs = ("instance_masks", "fg", "centers", "center_vals", "center_valid",
                   "eff_scale")

    else:
        raise NotImplementedError(f"Export not implemented for model type: {model_type}")

    return _Program(fn, backends, buffers), input_shape, outputs


def _build_composite_wrapper(model_dirs, peak_threshold: float, batch_size: int,
                             max_peaks: int, max_instances: int, input_height=None,
                             input_width=None, input_scale=None, crop_size=None,
                             use_bf16: bool = False, device="cuda"):
    """The centroid + instance-model pair as one program, crops cut in the
    graph: the live ``TopDownLayer``'s (or ``TopDownMultiClassLayer``'s)
    device function over traced backends. Returns ``(predictor, program,
    input_shape, output_names)``."""
    from sleap_nn_tpu_torch.inference.predictor import Predictor

    device = resolve_device(device)
    p = Predictor.from_model_paths(
        [str(d) for d in model_dirs], peak_threshold=peak_threshold, max_peaks=max_peaks,
        max_instances=max_instances, max_height=input_height, max_width=input_width,
        input_scale=input_scale, crop_size=crop_size, use_bf16=use_bf16, device=device)
    if p.model_type not in ("topdown", "multi_class_topdown"):
        raise NotImplementedError(
            f"Composite export supports topdown / multi_class_topdown; the given model dirs "
            f"resolve to {p.model_type}.")
    layer = copy.copy(p.layer)
    backends = {}
    for name in ("centroid_layer", "instance_layer"):
        stage = copy.copy(getattr(layer, name))
        stage.backend = backends[name] = _Backend(stage.backend.model, use_bf16, device)
        setattr(layer, name, stage)
    pre = layer.centroid_layer.pre
    input_shape = (batch_size, pre.max_height or 256, pre.max_width or 256,
                   3 if pre.ensure_rgb else 1)
    outputs = ("pred_keypoints", "pred_peak_values", "pred_centroids", "centroid_vals",
               "instance_valid")
    if p.model_type == "multi_class_topdown":
        outputs = outputs + ("class_probs",)
    return p, _Program(lambda self, images: layer.forward(images), backends), \
        input_shape, outputs


def _check_format(fmt: str) -> None:
    if fmt in _JAX_FORMATS:
        raise jax_format_refusal(f"--format {fmt}")
    if fmt != "pt2":
        raise ValueError(f"Unknown export format {fmt!r}; expected 'pt2'.")


def export_model(
    model_dir,
    output_dir=None,
    fmt: str = "pt2",
    batch_size: int = 4,
    peak_threshold: float = 0.2,
    max_peaks: int = 200,
    max_instances: int = 20,
    verify: bool = True,
    input_height: "Optional[int]" = None,
    input_width: "Optional[int]" = None,
    input_scale: "Optional[float]" = None,
    crop_size: "Optional[int]" = None,
    precision: str = "fp32",
    n_line_points: int = 10,
    max_edge_length_ratio: float = 0.25,
    dist_penalty_weight: float = 1.0,
    device="cuda",
) -> Path:
    """Export trained model dir(s) to ``model.pt2`` + ``metadata.json``
    (and a copy of ``training_config.yaml``).

    ``model_dir`` may be one dir or a [centroid, instance-model] pair for
    the topdown / multi_class_topdown composite program.
    ``input_height`` / ``input_width`` / ``input_scale`` override the baked
    input geometry; ``precision='bf16'`` bakes a bfloat16 forward. The
    program is traced and verified on ``device`` (the card unless
    ``"cpu"``); ``verify`` holds the loaded program to the untraced
    wrapper on a seeded uint8 batch (:func:`verify_export_numerics`).
    """
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"precision must be fp32 or bf16, got {precision!r}")
    _check_format(fmt)
    device = resolve_device(device)
    use_bf16 = precision == "bf16"

    if isinstance(model_dir, (list, tuple)) and len(model_dir) > 1:
        predictor, program, input_shape, output_names = _build_composite_wrapper(
            model_dir, peak_threshold, batch_size, max_peaks, max_instances,
            input_height=input_height, input_width=input_width, input_scale=input_scale,
            crop_size=crop_size, use_bf16=use_bf16, device=device)
        model_type = predictor.model_type
        anchor_part = next((a for a in (_anchor_part_from_config(m.config)
                                        for m in predictor.models) if a is not None), None)
        skeleton_nodes = tuple(predictor.skeleton.node_names)
        skeleton_edges = tuple(tuple(e) for e in predictor.skeleton.edge_names)
        # The instance model's config holds what the host stages need.
        cfg_dir = Path(model_dir[-1])
        model_dir = Path(model_dir[0])
    else:
        if isinstance(model_dir, (list, tuple)):
            model_dir = model_dir[0]
        loaded = load_model(model_dir)
        pre_cfg = loaded.config.data_config.preprocessing
        if input_height is not None:
            pre_cfg.max_height = int(input_height)
        if input_width is not None:
            pre_cfg.max_width = int(input_width)
        if input_scale is not None:
            pre_cfg.scale = float(input_scale)
        program, input_shape, output_names = _build_wrapper(
            loaded, peak_threshold, batch_size, max_peaks,
            paf_knobs={"n_points": n_line_points,
                       "max_edge_length_ratio": max_edge_length_ratio,
                       "dist_penalty_weight": dist_penalty_weight},
            use_bf16=use_bf16, device=device)
        model_type = loaded.model_type
        anchor_part = _anchor_part_from_config(loaded.config)
        skeleton_nodes = tuple(loaded.skeleton_nodes)
        skeleton_edges = tuple(tuple(e) for e in loaded.skeleton_edges)
        cfg_dir = Path(model_dir)

    output_dir = Path(output_dir or (Path(model_dir) / "exported"))
    output_dir.mkdir(parents=True, exist_ok=True)
    example = torch.zeros(input_shape, dtype=torch.uint8, device=device)
    # No gradients anywhere: the fused kernel has no backward.
    with torch.no_grad():
        exported = torch.export.export(program, (example,))
    torch.export.save(exported, str(output_dir / ARTIFACT))
    digest = hashlib.sha256((output_dir / ARTIFACT).read_bytes()).hexdigest()

    meta = ExportMetadata(
        model_type=model_type,
        input_shape=tuple(input_shape),
        input_dtype="uint8",
        output_names=tuple(output_names),
        peak_threshold=peak_threshold,
        skeleton_nodes=skeleton_nodes,
        skeleton_edges=skeleton_edges,
        artifact=ARTIFACT,
        artifact_sha256=digest,
        format=FORMAT,
        anchor_part=anchor_part,
        refinement="integral",
        max_peaks=max_peaks,
    )
    (output_dir / "metadata.json").write_text(meta.to_json())
    src_cfg = cfg_dir / "training_config.yaml"
    if src_cfg.exists():
        (output_dir / "training_config.yaml").write_text(src_cfg.read_text())

    if verify:
        rng = np.random.default_rng(0)
        x = rng.integers(0, 255, input_shape, dtype=np.uint8)
        report = verify_export_numerics(output_dir, program, x, device=device)
        if not report["ok"]:
            raise RuntimeError(f"Export verification failed: {report}")
    return output_dir


def check_runtime(runtime: str) -> None:
    """Raise ``ValueError`` unless ``runtime`` is ``'auto'`` or ``'pt2'``."""
    if runtime in _JAX_FORMATS:
        raise jax_format_refusal(f"runtime {runtime!r}")
    if runtime not in RUNTIMES:
        raise ValueError(f"Unknown runtime {runtime!r}; expected 'auto' or 'pt2'.")


def load_exported_model(export_dir, runtime: str = "auto", device="cuda"):
    """Load an export dir: returns ``(call, ExportMetadata)``.

    ``call(images)`` takes a uint8 batch of the baked shape (numpy or a
    tensor) and returns the program's outputs as tensors on ``device``
    (the card unless ``"cpu"``), where the loaded program runs whatever
    device it was exported on. ``runtime`` is ``'auto'`` or ``'pt2'``;
    the JAX package's runtimes and export dirs raise ``ValueError``.
    """
    export_dir = Path(export_dir)
    check_runtime(runtime)
    meta_path = export_dir / "metadata.json"
    if not meta_path.is_file():
        raise FileNotFoundError(
            f"{export_dir} is not an export dir: missing metadata.json "
            "(produce one with `sleap-nn-tpu-torch export`).")
    meta = ExportMetadata.from_json(meta_path.read_text())
    if meta.format != FORMAT:
        raise jax_format_refusal(f"{export_dir} ({meta.format!r}, artifact {meta.artifact!r})")
    if runtime == "pt2" and meta.artifact != ARTIFACT:
        raise ValueError(
            f"--runtime 'pt2': this export dir's metadata names {meta.artifact!r}, "
            f"not {ARTIFACT!r}. Export it again with --format pt2.")
    artifact = export_dir / meta.artifact
    if not artifact.is_file():
        raise FileNotFoundError(f"{artifact}: the export dir's artifact is missing.")
    if hashlib.sha256(artifact.read_bytes()).hexdigest() != meta.artifact_sha256:
        raise ValueError("Exported artifact hash mismatch (corrupted file).")
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    # Tensors the program made at trace time (arange, zeros) carry the
    # trace's device: the pass moves them, and the weights, to ``device``.
    program = move_to_device_pass(torch.export.load(str(artifact)), device).module()
    program.requires_grad_(False)

    def call(images) -> Dict[str, torch.Tensor]:
        if isinstance(images, np.ndarray):
            images = torch.from_numpy(np.ascontiguousarray(images))
        with torch.inference_mode():
            return program(images.to(device))

    return call, meta


def _as_numpy(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).cpu().numpy()
            for k, v in out.items()}


def verify_export_numerics(export_dir, eager_fn, x: np.ndarray, atol: float = 1e-4,
                           device="cuda") -> Dict:
    """Compare the loaded program's outputs with ``eager_fn``'s (the
    untraced wrapper) on ``x``: ``{"ok", "max_abs_diff": {name: d}}``,
    non-finite sentinels equal where both sides place them alike."""
    device = resolve_device(device)
    call, _ = load_exported_model(export_dir, device=device)
    out_e = _as_numpy(call(x))
    with torch.inference_mode():
        out_r = _as_numpy(eager_fn(torch.from_numpy(np.ascontiguousarray(x)).to(device)))
    report = {"ok": True, "max_abs_diff": {}}
    for k in out_r:
        a, b = np.asarray(out_e[k], dtype=np.float64), np.asarray(out_r[k], dtype=np.float64)
        same_sentinel = (np.isnan(a) & np.isnan(b)) | (
            np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b)))
        with np.errstate(invalid="ignore"):
            d = np.abs(np.where(same_sentinel, 0.0, a - b))
        d = np.nan_to_num(d, nan=np.inf)
        md = float(d.max()) if d.size else 0.0
        report["max_abs_diff"][k] = md
        if md > atol:
            report["ok"] = False
    return report



