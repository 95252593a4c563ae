"""Top-level ``predict()`` entry point.

Port of ``predict`` and ``save_predictions`` of
``sleap_nn_tpu/inference/run.py``: trained model dirs in, predicted
``Labels`` out, optionally written to a ``.slp`` file (h5py). The source is
a port ``Labels``, a ``.slp`` path or an in-memory video; the run goes
through ``Predictor.from_model_paths`` on ``device`` (the card unless
``"cpu"``). With ``tracking=True`` (or a ``tracker``) the predicted
``Labels`` are tracked on the host (``tracking.run_tracker``, its knobs
passed as keyword arguments). What the port lacks raises
``NotImplementedError`` naming its ROADMAP.md item: video files by name
(item 3), exported model dirs, SAM masks, profiling, output formats other than
``slp`` and the JAX ``predict``'s source-scoping and output options (item
13, with the command line that sets them), and the ``from_model_paths``
knobs listed in ``predictor.UNPORTED_KNOBS``. Remote inputs (``http://...``) are refused:
``fetch_remote_data`` needs the network and stays out of the port.
"""

from __future__ import annotations

import inspect
import re
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from sleap_nn_tpu_torch.inference.predictor import UNPORTED_KNOBS, Predictor, refuse_unported
from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels
from sleap_nn_tpu_torch.tracking.tracker import Tracker, run_tracker

_URL_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")
_ITEM13 = "(ROADMAP.md section 1, item 13)"

# Knobs of the JAX ``predict`` whose features the port lacks: name -> (the
# value that asks for nothing, why another value raises).
UNPORTED_RUN_KNOBS = {
    **UNPORTED_KNOBS,
    "centroid_output": ("instance", "centroid records come from centroid-only inference, "
                                    "which is not ported (ROADMAP.md section 1, item 2)"),
    "runtime": ("auto", f"exported model dirs are not ported {_ITEM13}"),
    "profile_dir": (None, f"profiling a predict run is not ported {_ITEM13}"),
    "headers": (None, "remote inputs need the network; fetch_remote_data is not ported"),
    "stream_mode": (None, "remote inputs need the network; fetch_remote_data is not ported"),
    **{name: (default, f"the predict() option {name} is not ported {_ITEM13}")
       for name, default in (("video_path_map", None), ("video_index", None),
                             ("exclude_user_labeled", False), ("only_labeled_frames", False),
                             ("only_predicted_frames", False), ("no_empty_frames", False),
                             ("queue_maxsize", None), ("restore_source_videos", False),
                             ("video_dataset", None), ("video_input_format", "channels_last"))},
    **{name: (default, f"SAM prompted segmentation is not ported {_ITEM13}")
       for name, default in (("mask_backend", None), ("sam_model_id", "facebook/sam-vit-huge"),
                             ("sam_prompt_mode", "pose"), ("sam_anchor_ind", None),
                             ("sam_disjointify_masks", False), ("sam_overlay_path", None),
                             ("sam_backend", None))},
}


def is_remote_url(path: str) -> bool:
    """True for ``scheme://`` inputs, False for local paths (``C:\\...`` too)."""
    return bool(_URL_RE.match(path)) and "://" in path


def _validate_tracker_kwargs(kwargs: Dict) -> None:
    """Reject keyword arguments that are neither ``predict()`` parameters
    nor tracking knobs: the knobs of ``run_tracker`` and
    ``Tracker.from_config``, read from their signatures. Without this a
    typo'd parameter would be dropped in silence whenever tracking is off."""
    allowed = set()
    for fn in (run_tracker, Tracker.from_config):
        for name, p in inspect.signature(fn).parameters.items():
            if p.kind in (p.POSITIONAL_OR_KEYWORD, p.KEYWORD_ONLY):
                allowed.add(name)
    allowed.discard("labels")
    unknown = sorted(set(kwargs) - allowed)
    if unknown:
        raise TypeError(
            f"predict() got unexpected keyword arguments {unknown} "
            "(not recognized as tracking knobs either).")


def _as_labels(data) -> Labels:
    if isinstance(data, Labels):
        return data
    from sleap_nn_tpu_torch.io.slp import load_slp

    return load_slp(str(data))


def predict(
    data_path,
    model_paths: Sequence[Union[str, Path]],
    output_path: Optional[Union[str, Path]] = None,
    frames: Optional[Sequence[int]] = None,
    peak_threshold: float = 0.2,
    refinement: str = "integral",
    integral_patch_size: int = 5,
    max_instances: Optional[int] = None,
    batch_size: int = 4,
    use_bf16: bool = False,
    max_peaks: int = 200,
    min_line_scores: float = 0.25,
    paf_workers: int = 0,
    embed: bool = False,
    device: Optional[str] = None,
    crop_size: Optional[int] = None,
    output_format: Union[str, Sequence[str]] = "slp",
    filters=None,
    only_suggested_frames: bool = False,
    centroid_peak_threshold: Optional[float] = None,
    make_labels: bool = True,
    input_scale: Optional[float] = None,
    max_height: Optional[int] = None,
    max_width: Optional[int] = None,
    ensure_rgb: Optional[bool] = None,
    ensure_grayscale: Optional[bool] = None,
    max_edge_length_ratio: float = 0.25,
    dist_penalty_weight: float = 1.0,
    n_points: int = 10,
    min_instance_peaks: float = 0,
    stream_to_file: Optional[Union[str, Path]] = None,
    write_interval: Optional[int] = None,
    progress_callback=None,
    tracking: bool = False,
    tracker=None,
    **tracker_kwargs,
):
    """Run inference on a labels or video source with one or two trained
    models (``model_paths``: single-instance, the centroid +
    centered-instance pair, or bottom-up).

    Returns ``Labels`` (and writes ``output_path`` if given), or the
    per-batch output dicts with ``make_labels=False``. ``device`` is the
    card unless ``"cpu"``. ``tracking`` tracks the ``Labels`` with
    ``run_tracker`` and the other keyword arguments as its knobs
    (``features`` and ``scoring_method`` left unset give centroids and
    euclidean distances for a one-node skeleton); a ``tracker`` object's
    ``track_labels`` is used instead when given. Keyword arguments that
    are the JAX package's knobs of unported features
    (``UNPORTED_RUN_KNOBS``) raise unless they hold their no-op value;
    a name that is neither raises ``TypeError``.
    """
    unported = {k: tracker_kwargs.pop(k) for k in list(tracker_kwargs)
                if k in UNPORTED_RUN_KNOBS}
    _validate_tracker_kwargs(tracker_kwargs)
    tracks = bool(tracking or tracker is not None)
    centroid_output = unported.get("centroid_output", "instance")
    if centroid_output != "instance" and tracks:
        # The tracker operates on PredictedInstance records, which centroid
        # records are not.
        raise ValueError(
            "Tracking is incompatible with centroid_output="
            f"{centroid_output!r}: tracking operates on PredictedInstance, "
            "not centroid records. Use centroid_output='instance' (the "
            "default) for tracking.")
    refuse_unported(unported, UNPORTED_RUN_KNOBS, "predict")
    formats = {output_format} if isinstance(output_format, str) else set(output_format)
    if formats != {"slp"}:
        raise NotImplementedError(
            f"output_format {sorted(formats)}: only 'slp' is ported (the analysis HDF5 export "
            f"is {_ITEM13[1:-1]})")

    if isinstance(data_path, (str, Path)) and is_remote_url(str(data_path)):
        raise NotImplementedError(
            f"{data_path}: remote inputs need the network; fetch_remote_data is not ported")
    if isinstance(data_path, (str, Path)) and not str(data_path).endswith(".slp"):
        raise NotImplementedError(
            f"reading the video file {str(data_path)!r} needs the media video backends, which "
            "are not ported (ROADMAP.md section 1, item 3)")

    frame_selection_method = (
        "suggested" if only_suggested_frames else "list" if frames else "all")
    if only_suggested_frames:
        # Predict the suggested frames (which may be unlabeled).
        labels = _as_labels(data_path)
        if not labels.suggestions:
            raise ValueError("only_suggested_frames: the labels file has no suggestions.")
        wanted = set(frames) if frames else None
        data_path = Labels(
            labeled_frames=[
                LabeledFrame(video=s_.video, frame_idx=s_.frame_idx, instances=[])
                for s_ in labels.suggestions
                if wanted is None or s_.frame_idx in wanted
            ],
            videos=labels.videos,
            skeletons=labels.skeletons,
        )
        frames = None

    predictor = Predictor.from_model_paths(
        model_paths,
        peak_threshold=peak_threshold,
        refinement=refinement,
        integral_patch_size=integral_patch_size,
        max_instances=max_instances,
        batch_size=batch_size,
        use_bf16=use_bf16,
        max_peaks=max_peaks,
        min_line_scores=min_line_scores,
        crop_size=crop_size,
        filters=filters,
        paf_workers=paf_workers,
        centroid_peak_threshold=centroid_peak_threshold,
        input_scale=input_scale,
        max_height=max_height,
        max_width=max_width,
        ensure_rgb=ensure_rgb,
        ensure_grayscale=ensure_grayscale,
        max_edge_length_ratio=max_edge_length_ratio,
        dist_penalty_weight=dist_penalty_weight,
        n_points=n_points,
        min_instance_peaks=min_instance_peaks,
        device=device or "cuda",
    )
    predictor.progress_callback = progress_callback
    predictor.tracking_active = tracks
    stream_writer = None
    if make_labels and stream_to_file is not None:
        # Frames flush to a temp .slp during prediction; atomic rename at
        # the end. Tracking rewrites frames after the whole run, so the
        # two do not combine.
        if tracks:
            raise ValueError(
                "stream_to_file streams frames as they are predicted and "
                "cannot be combined with tracking or no_empty_frames "
                "(those rewrite frames after the full run).")
        from sleap_nn_tpu_torch.inference.writer import IncrementalLabelsWriter

        stream_writer = IncrementalLabelsWriter(stream_to_file,
                                                flush_every=int(write_interval or 500))
        predictor.stream_writer = stream_writer
    result = predictor.predict(data_path, frames=frames, make_labels=make_labels)
    if not make_labels:
        return result
    if tracker is not None:
        result = tracker.track_labels(result)
    elif tracking:
        if "features" not in tracker_kwargs and len(predictor.skeleton.nodes) == 1:
            tracker_kwargs["features"] = "centroids"
        if "scoring_method" not in tracker_kwargs \
                and tracker_kwargs.get("features") == "centroids":
            tracker_kwargs["scoring_method"] = "euclidean_dist"
        result = run_tracker(result, **tracker_kwargs)

    from sleap_nn_tpu_torch.inference.provenance import (
        build_inference_provenance,
        merge_provenance,
    )

    run_prov = build_inference_provenance(
        model_dirs=None,
        model_type=predictor.model_type,
        input_path=None if isinstance(data_path, Labels) else data_path,
        input_labels=data_path if isinstance(data_path, Labels) else None,
        frames_processed=len(result.labeled_frames),
        frame_selection_method=frame_selection_method,
        inference_params={
            "peak_threshold": peak_threshold,
            "batch_size": batch_size,
            "refinement": refinement,
            "max_instances": max_instances,
        },
        tracking_params=tracker_kwargs if tracks else None,
        device=device,
        include_system_info=False,  # the predictor's provenance has the versions
        backend=predictor.device.type,
    )
    result.provenance = merge_provenance(dict(result.provenance or {}), run_prov,
                                         overwrite=False)
    if stream_writer is not None:
        stream_writer.provenance = dict(result.provenance)
        stream_writer.finalize()
        predictor.stream_writer = None
    if output_path is not None:
        save_predictions(result, output_path, embed=embed)
    return result


def save_predictions(labels: Labels, output_path, output_format: Union[str, Sequence[str]] = "slp",
                     video_index: Optional[int] = None, embed: bool = False):
    """Save predictions as ``.slp``. Returns the analysis HDF5 paths written:
    none, since that export is not ported (item 13, which ``output_format``
    other than ``slp`` raises for)."""
    formats = {output_format} if isinstance(output_format, str) else set(output_format)
    if formats != {"slp"} or video_index is not None:
        raise NotImplementedError(
            f"output_format {sorted(formats)} / video_index: the analysis HDF5 export is not "
            f"ported {_ITEM13}")
    labels.save(str(output_path), embed=embed)
    return []
