"""Top-level ``predict()`` entry point.

Port of ``predict`` and ``save_predictions`` of
``sleap_nn_tpu/inference/run.py``: trained model dirs in, predicted
``Labels`` out, optionally written to a ``.slp`` file and / or SLEAP
Analysis HDF5 files (``io/hdf5.py``). The source is a port ``Labels``, a ``.slp``
path, a video file's path (media, image, or an HDF5 dataset with
``video_dataset``) or an in-memory video; the source-scoping options
(``video_path_map``, ``video_index``, ``exclude_user_labeled``,
``only_labeled_frames``, ``only_predicted_frames``,
``only_suggested_frames``) narrow a labels source first. The run goes
through ``Predictor.from_model_paths`` on ``device`` (the card unless
``"cpu"``); a lone export dir (``metadata.json`` + ``model.pt2``, from
``export.export_model``) runs through ``Predictor.from_export_dir``
instead, and the rest of the run is the same. With ``tracking=True`` (or
a ``tracker``) the predicted ``Labels`` are tracked on the host
(``tracking.run_tracker``, its knobs passed as keyword arguments).
``profile_dir`` writes a ``torch.profiler`` trace of the predict loop
(``profiling.trace``). With ``mask_backend`` the call is SAM prompted
segmentation of the poses already in a labels source
(``inference.sam.run_sam_segmentation``, on ``device``) and no model runs.
A ``scheme://`` source is first made local by ``fetch_remote_data``:
``file://`` in place, ``http(s)://`` downloaded (with ``headers``) to a
temporary file removed at exit. What the port lacks raises
``NotImplementedError``: the ``from_model_paths`` knobs listed in
``predictor.UNPORTED_KNOBS``.
"""

from __future__ import annotations

import atexit
import contextlib
import inspect
import logging
import re
import shutil
import tempfile
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

from sleap_nn_tpu_torch.inference.predictor import (
    SEGMENTATION_TYPES,
    UNPORTED_KNOBS,
    Predictor,
    refuse_unported,
)
from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels
from sleap_nn_tpu_torch.io.video import HDF5VideoBackend, Video
from sleap_nn_tpu_torch.profiling import trace
from sleap_nn_tpu_torch.tracking.tracker import Tracker, run_tracker

logger = logging.getLogger("sleap_nn_tpu_torch")
_URL_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")

# Knobs of the JAX ``predict`` whose features the port lacks: name -> (the
# value that asks for nothing, why another value raises). They are all
# ``from_model_paths``' own.
UNPORTED_RUN_KNOBS = UNPORTED_KNOBS


def is_remote_url(path: str) -> bool:
    """True for ``scheme://`` inputs, False for local paths (``C:\\...`` too)."""
    return bool(_URL_RE.match(path)) and "://" in path


def fetch_remote_data(
    url: str,
    headers: Optional[Dict[str, str]] = None,
    stream_mode: str = "download",
    timeout: float = 60.0,
) -> str:
    """A remote data URL as a local file path.

    ``file://`` resolves in place (no copy). ``http(s)://`` downloads to a
    temporary file that keeps the URL's full suffix (``.pkg.slp`` stays
    ``.pkg.slp``), so that ``.slp`` and video routing work on it, with
    ``headers`` on the request; the file is removed at interpreter exit.
    Any other scheme (``s3``, ``gs``, ...) needs a credentialed client and
    raises ``ValueError``. ``stream_mode="stream"`` downloads first too.
    """
    # Imported here, so that a patch of ``urllib.request.urlopen`` reaches it.
    from urllib.parse import unquote, urlparse
    from urllib.request import Request, url2pathname, urlopen

    parsed = urlparse(url)
    scheme = parsed.scheme.lower()
    if scheme == "file":
        return url2pathname(parsed.path)
    if scheme in ("http", "https"):
        name = unquote(Path(parsed.path).name) or "remote_data"
        suffix = name[name.index("."):] if "." in name else ""
        req = Request(url, headers=dict(headers or {}))
        # The connection opens before the file is made, so a failed request
        # (404, DNS, a stall) leaves no empty file; ``timeout`` bounds the
        # connect and each read.
        with urlopen(req, timeout=timeout) as resp:
            tmp = tempfile.NamedTemporaryFile(
                suffix=suffix, prefix="sleap_nn_tpu_torch_remote_", delete=False)
            try:
                with tmp:
                    shutil.copyfileobj(resp, tmp)
            except BaseException:
                Path(tmp.name).unlink(missing_ok=True)
                raise
        # The copy backs this process's run only: repeated runs must not
        # pile full-size copies up in the temporary directory.
        atexit.register(lambda p=tmp.name: Path(p).unlink(missing_ok=True))
        return tmp.name
    raise ValueError(
        f"Remote scheme {scheme!r} needs a credentialed client this build "
        f"does not ship (got {url!r}); download the file and pass a local "
        "path, or use an http(s):// URL."
    )


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
    centroid_only: bool = False,
    embed: bool = False,
    video_path_map: Optional[str] = None,
    device: Optional[str] = None,
    host_resize: bool = False,
    crop_size: Optional[int] = None,
    output_format: Union[str, Sequence[str]] = "slp",
    filters=None,
    no_empty_frames: bool = False,
    only_suggested_frames: bool = False,
    exclude_user_labeled: bool = False,
    only_labeled_frames: bool = False,
    only_predicted_frames: bool = False,
    centroid_peak_threshold: Optional[float] = None,
    anchor_part: Optional[str] = None,
    video_index: Optional[int] = None,
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
    backbone_ckpt_path: Optional[Union[str, Path]] = None,
    head_ckpt_path: Optional[Union[str, Path]] = None,
    centroid_output: str = "instance",
    stream_to_file: Optional[Union[str, Path]] = None,
    write_interval: Optional[int] = None,
    video_dataset: Optional[str] = None,
    video_input_format: str = "channels_last",
    headers: Optional[Dict[str, str]] = None,
    stream_mode: Optional[str] = None,
    queue_maxsize: Optional[int] = None,
    progress_callback=None,
    restore_source_videos: bool = False,
    tracking: bool = False,
    tracker=None,
    merge_fragments: bool = False,
    merge_method: str = "greedy",
    fg_threshold: float = 0.5,
    min_mask_area: int = 0,
    center_nms_kernel: int = 3,
    distance_gate_alpha: Optional[float] = None,
    mask_cleanup: bool = True,
    mask_cleanup_radius: int = 0,
    merge_dilate: int = 1,
    merge_w_valley: float = 1.0,
    merge_w_offset: float = 0.25,
    merge_thresholds: Sequence[float] = (0.85, 0.6, 0.4),
    full_res_masks: bool = False,
    mask_output: str = "mask",
    polygon_epsilon: float = 0.01,
    runtime: str = "auto",
    profile_dir: Optional[Union[str, Path]] = None,
    data_parallel: bool = False,
    mask_backend: Optional[str] = None,
    sam_model_id: str = "facebook/sam-vit-huge",
    sam_prompt_mode: str = "pose",
    sam_anchor_ind: Optional[int] = None,
    sam_disjointify_masks: bool = False,
    sam_overlay_path: Optional[Union[str, Path]] = None,
    sam_backend=None,
    **tracker_kwargs,
):
    """Run inference on a labels or video source with one or two trained
    models (``model_paths``: single-instance, centroid, the centroid +
    centered-instance pair, bottom-up, or an identity model or pair; a
    lone centered-instance model crops around the ground-truth centroids
    of a labels source, at the ``anchor_part`` node where it is visible,
    and with ``only_labeled_frames`` from the user instances alone).

    Returns ``Labels`` (and writes ``output_path`` if given, as ``.slp``
    and / or ``analysis_h5`` per ``output_format``), or the per-batch
    output dicts with ``make_labels=False``. ``device`` is the card unless
    ``"cpu"``. ``queue_maxsize`` bounds the decode queue, in frames.
    ``no_empty_frames`` drops frames left without an instance;
    ``restore_source_videos`` points a non-embedding save at the videos
    that embedded frames came from. ``tracking`` tracks the ``Labels`` with
    ``run_tracker`` and the other keyword arguments as its knobs
    (``features`` and ``scoring_method`` left unset give masks and mask
    IoU for a segmentation model, else centroids and euclidean distances
    for a one-node skeleton); a ``tracker`` object's
    ``track_labels`` is used instead when given. Keyword arguments that
    are the JAX package's knobs of unported features
    (``UNPORTED_RUN_KNOBS``) raise unless they hold their no-op value;
    a name that is neither raises ``TypeError``. A lone model path that is
    an export dir loads its program (``runtime`` ``"auto"`` or ``"pt2"``;
    the JAX package's ``"stablehlo"`` / ``"savedmodel"`` raise
    ``ValueError``); the program baked the peak threshold, refinement and
    peak count, and a differing request is logged as ignored.
    ``profile_dir`` traces the predict loop into that directory. A
    ``scheme://`` ``data_path`` is made local first by
    ``fetch_remote_data`` (``headers`` ride an ``http(s)`` request;
    ``stream_mode`` ``"stream"`` downloads first too); ``headers`` on a
    local path are ignored, as in the JAX package.
    ``data_parallel`` predicts with one replica of the models on each card
    this process sees (``Predictor.from_model_paths``); an export dir
    ignores it, as in the JAX package. It is currently slower than one
    card: one host thread enqueues every replica's work.

    When ``mask_backend`` is set, ``data_path`` is a pose ``.slp`` (or
    ``Labels``) and ``model_paths`` must be empty: the poses it holds prompt
    one SAM mask per instance (``run_sam_segmentation`` with the
    ``sam_*`` knobs, ``output_path`` and ``frames``, on ``device``: the
    card unless ``"cpu"``).
    """
    unported = {k: tracker_kwargs.pop(k) for k in list(tracker_kwargs)
                if k in UNPORTED_RUN_KNOBS}
    refuse_unported(unported, UNPORTED_RUN_KNOBS, "predict")
    formats = _normalize_output_formats(output_format)
    if isinstance(data_path, (str, Path)) and is_remote_url(str(data_path)):
        data_path = fetch_remote_data(str(data_path), headers=headers, stream_mode=stream_mode)

    if video_dataset is not None and isinstance(data_path, (str, Path)):
        # Frames of a dataset inside an HDF5 file.
        data_path = Video(filename=str(data_path), backend=HDF5VideoBackend(
            str(data_path), dataset=video_dataset, input_format=video_input_format))

    if video_path_map:
        # Remap the video paths of a labels source ("old=new,..."), for
        # labels files moved between machines.
        labels = _as_labels(data_path)
        mapping = dict(pair.split("=", 1) for pair in str(video_path_map).split(","))
        for vid in labels.videos:
            fn = str(vid.filename)
            for old, new in mapping.items():
                if fn == old or fn.startswith(old):
                    vid.filename = fn.replace(old, new, 1)
                    vid.backend = None  # reopened at the new path
                    break
        data_path = labels

    if video_index is not None:
        # One video of a multi-video labels source, with its suggestions.
        labels = _as_labels(data_path)
        if not 0 <= video_index < len(labels.videos):
            raise ValueError(f"video_index {video_index} out of range: the source has "
                             f"{len(labels.videos)} video(s).")
        target = labels.videos[video_index]
        data_path = Labels(
            labeled_frames=[lf for lf in labels.labeled_frames if lf.video is target],
            videos=[target],
            skeletons=labels.skeletons,
            suggestions=[s_ for s_ in labels.suggestions if s_.video is target],
            provenance=dict(labels.provenance),
        )

    if exclude_user_labeled:
        # Frames a human labeled are not predicted again.
        labels = _as_labels(data_path)
        data_path = Labels(
            labeled_frames=[lf for lf in labels.labeled_frames if not lf.has_user_instances],
            videos=labels.videos, skeletons=labels.skeletons, suggestions=labels.suggestions)

    if only_labeled_frames or only_predicted_frames:
        # The frames that carry user labels, or predictions, already.
        labels = _as_labels(data_path)
        keep = [lf for lf in labels.labeled_frames
                if (not only_labeled_frames or lf.has_user_instances)
                and (not only_predicted_frames or lf.has_predicted_instances)]
        data_path = Labels(labeled_frames=keep, videos=labels.videos,
                           skeletons=labels.skeletons, suggestions=labels.suggestions)

    frame_selection_method = (
        "suggested" if only_suggested_frames else "labeled" if only_labeled_frames
        else "list" if frames else "all")
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

    _validate_tracker_kwargs(tracker_kwargs)
    tracks = bool(tracking or tracker is not None)
    if centroid_output != "instance" and tracks:
        # The tracker operates on PredictedInstance records, which centroid
        # records are not.
        raise ValueError(
            "Tracking is incompatible with centroid_output="
            f"{centroid_output!r}: tracking operates on PredictedInstance, "
            "not centroid records. Use centroid_output='instance' (the "
            "default) for tracking.")

    if mask_backend is not None:
        if model_paths:
            # Prompted segmentation uses the poses already in the .slp, so a
            # trained model makes the request ambiguous.
            raise ValueError(
                "mask_backend cannot be combined with model_paths: SAM "
                "prompted segmentation reads poses from the input .slp. "
                "Drop model_paths, or run predict without mask_backend.")
        from sleap_nn_tpu_torch.inference.sam import run_sam_segmentation

        return run_sam_segmentation(
            data_path,
            mask_backend,
            backend=sam_backend,
            prompt_mode=sam_prompt_mode,
            sam_model_id=sam_model_id,
            device=device,
            anchor_ind=sam_anchor_ind,
            disjointify_masks=sam_disjointify_masks,
            output_path=output_path,
            overlay_path=sam_overlay_path,
            frames=frames,
        )

    mp = Path(model_paths[0]) if len(model_paths) == 1 else None
    if mp is not None and (mp / "metadata.json").exists() and (
            (mp / "model.pt2").exists() or (mp / "model.stablehlo").exists()
            or (mp / "savedmodel").is_dir()):
        # The artifact is checked against the metadata (and a JAX-written
        # dir refused) by load_exported_model.
        predictor = Predictor.from_export_dir(mp, max_instances=max_instances,
                                              min_line_scores=min_line_scores,
                                              runtime=runtime, device=device or "cuda")
        predictor.filters = filters
        predictor.mask_output = mask_output
        predictor.polygon_epsilon = polygon_epsilon
        meta = predictor.layer.meta
        for flag, requested in (("peak_threshold", peak_threshold),
                                ("refinement", refinement), ("max_peaks", max_peaks)):
            baked = getattr(meta, flag, None)
            if baked is not None and requested is not None and requested != baked:
                logger.warning(
                    "%s=%s ignored: this export dir baked %s into the compiled graph at "
                    "export time — re-export with the desired value, or use filter flags "
                    "for post-hoc screening.", flag, requested, baked)
    else:
        from sleap_nn_tpu_torch.export.exporter import check_runtime

        check_runtime(runtime)
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
            host_resize=host_resize,
            centroid_only=centroid_only,
            input_scale=input_scale,
            max_height=max_height,
            max_width=max_width,
            ensure_rgb=ensure_rgb,
            ensure_grayscale=ensure_grayscale,
            max_edge_length_ratio=max_edge_length_ratio,
            dist_penalty_weight=dist_penalty_weight,
            n_points=n_points,
            min_instance_peaks=min_instance_peaks,
            backbone_ckpt_path=backbone_ckpt_path,
            head_ckpt_path=head_ckpt_path,
            anchor_part=anchor_part,
            merge_fragments=merge_fragments,
            merge_method=merge_method,
            fg_threshold=fg_threshold,
            min_mask_area=min_mask_area,
            center_nms_kernel=center_nms_kernel,
            distance_gate_alpha=distance_gate_alpha,
            mask_cleanup=mask_cleanup,
            mask_cleanup_radius=mask_cleanup_radius,
            merge_dilate=merge_dilate,
            merge_w_valley=merge_w_valley,
            merge_w_offset=merge_w_offset,
            merge_thresholds=merge_thresholds,
            full_res_masks=full_res_masks,
            mask_output=mask_output,
            polygon_epsilon=polygon_epsilon,
            data_parallel=data_parallel,
            device=device or "cuda",
        )
    predictor.centroid_output = centroid_output
    # Ground-truth centroids of a mixed frame come from its user instances
    # alone when only the user-labeled frames are predicted.
    predictor.gt_user_instances_only = bool(only_labeled_frames)
    if queue_maxsize:
        # Frames -> whole batches of decode queue.
        predictor.prefetch_batches = max(1, int(queue_maxsize) // max(1, predictor.batch_size))
    predictor.progress_callback = progress_callback
    predictor.tracking_active = tracks
    stream_writer = None
    if make_labels and stream_to_file is not None:
        # Frames flush to a temp .slp during prediction; atomic rename at
        # the end. Tracking and no_empty_frames rewrite frames after the
        # whole run, so they do not combine with it.
        if tracks or no_empty_frames:
            raise ValueError(
                "stream_to_file streams frames as they are predicted and "
                "cannot be combined with tracking or no_empty_frames "
                "(those rewrite frames after the full run).")
        from sleap_nn_tpu_torch.inference.writer import IncrementalLabelsWriter

        stream_writer = IncrementalLabelsWriter(stream_to_file,
                                                flush_every=int(write_interval or 500))
        predictor.stream_writer = stream_writer
    # A trace of the predict loop: the device's kernels and copies beside
    # the host's decode and grouping (TensorBoard / Perfetto).
    with (trace(profile_dir, predictor.device) if profile_dir is not None
          else contextlib.nullcontext()):
        result = predictor.predict(data_path, frames=frames, make_labels=make_labels)
    if not make_labels:
        return result
    if tracker is not None:
        result = tracker.track_labels(result)
    elif tracking:
        if "features" not in tracker_kwargs:
            if predictor.model_type in SEGMENTATION_TYPES:
                tracker_kwargs["features"] = "masks"
            elif predictor.model_type == "centroid" or len(predictor.skeleton.nodes) == 1:
                tracker_kwargs["features"] = "centroids"
        if "scoring_method" not in tracker_kwargs:
            default = {"masks": "mask_iou", "centroids": "euclidean_dist"}
            if tracker_kwargs.get("features") in default:
                tracker_kwargs["scoring_method"] = default[tracker_kwargs["features"]]
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
    if no_empty_frames:
        result.labeled_frames = [lf for lf in result.labeled_frames
                                 if lf.instances or lf.masks]
    if stream_writer is not None:
        stream_writer.provenance = dict(result.provenance)
        stream_writer.finalize()
        predictor.stream_writer = None
    if restore_source_videos and not embed:
        # A non-embedding save points at the videos the embedded frames
        # came from, where they are recorded.
        for vid in list(result.videos):
            src = getattr(vid, "source_video", None)
            if src is not None:
                result.videos[result.videos.index(vid)] = src
                for lf in result.labeled_frames:
                    if lf.video is vid:
                        lf.video = src
    if output_path is not None:
        save_predictions(result, output_path, output_format=formats, embed=embed)
    return result


def _normalize_output_formats(output_format) -> set:
    formats = {output_format} if isinstance(output_format, str) else set(output_format)
    bad = formats - {"slp", "analysis_h5"}
    if bad:
        raise ValueError(
            f"Unknown output_format {sorted(bad)}; expected 'slp' and/or 'analysis_h5'.")
    return formats


def save_predictions(labels: Labels, output_path, output_format: Union[str, Sequence[str]] = "slp",
                     video_index: Optional[int] = None, embed: bool = False):
    """Save predictions as ``.slp`` and / or SLEAP Analysis HDF5 (one file per
    video with predictions, or the one of ``video_index``). Returns the
    analysis HDF5 paths written (none unless ``analysis_h5`` was asked)."""
    from sleap_nn_tpu_torch.io.analysis import save_analysis_h5_files

    formats = _normalize_output_formats(output_format)
    if "slp" in formats:
        labels.save(str(output_path), embed=embed)
    if "analysis_h5" in formats:
        return save_analysis_h5_files(labels, output_path, video_index=video_index)
    return []
