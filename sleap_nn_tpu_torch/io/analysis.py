"""SLEAP Analysis HDF5 export.

Port of ``sleap_nn_tpu/io/analysis.py``: one file per video, in the
sleap-io analysis layout:

- ``tracks``: ``(n_tracks, n_nodes, 2, n_frames)`` float64 — frame axis LAST,
  spanning ``len(video)`` (not last-labeled-frame + 1).
- ``track_occupancy``: ``(n_frames, n_tracks)``.
- ``point_scores`` ``(n_tracks, n_nodes, n_frames)``, ``instance_scores`` /
  ``tracking_scores`` ``(n_tracks, n_frames)``.
- ``node_names`` / ``track_names`` / ``edge_names`` / ``edge_inds`` and the
  ``video_path`` / ``video_ind`` / ``labels_path`` / ``provenance`` scalars.

Untracked instances get rank-order pseudo-tracks (``track_0``...), as
sleap-io exports them, so that readers always see a dense track axis.
h5py is imported by the writer only.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from sleap_nn_tpu_torch.io.model import Labels, PredictedInstance


def _video_n_frames(video, labeled_frames) -> int:
    """len(video) when knowable, else last labeled frame + 1."""
    try:
        shape = getattr(video, "shape", None)
        if shape is not None and shape[0]:
            return int(shape[0])
    except Exception:
        pass
    try:
        return len(video)
    except Exception:
        return max((lf.frame_idx for lf in labeled_frames), default=-1) + 1


def save_analysis_h5(
    labels: Labels,
    path: Union[str, Path],
    video: int = 0,
    labels_path: Optional[str] = None,
) -> Path:
    """Write one video's predictions as a SLEAP Analysis HDF5 file."""
    import h5py

    vid = labels.videos[video] if labels.videos else None
    lfs = [
        lf for lf in labels.labeled_frames
        if (vid is None or lf.video is vid) and lf.predicted_instances
    ]
    skel = labels.skeleton
    node_names = list(skel.node_names) if skel else []
    n_nodes = len(node_names)

    # Track axis: real tracks when any instance carries one, else rank order.
    tracks = [t for t in labels.tracks]
    any_tracked = any(
        inst.track is not None for lf in lfs for inst in lf.predicted_instances
    )
    if any_tracked and tracks:
        track_names = [t.name for t in tracks]
        track_of = {id(t): i for i, t in enumerate(tracks)}

        def slot(inst, rank):
            return track_of.get(id(inst.track), None)
    else:
        max_inst = max((len(lf.predicted_instances) for lf in lfs), default=0)
        track_names = [f"track_{i}" for i in range(max_inst)]

        def slot(inst, rank):
            return rank

    n_tracks = len(track_names)
    n_frames = _video_n_frames(vid, lfs)

    pts = np.full((n_tracks, n_nodes, 2, n_frames), np.nan, np.float64)
    point_scores = np.full((n_tracks, n_nodes, n_frames), np.nan, np.float64)
    instance_scores = np.full((n_tracks, n_frames), np.nan, np.float64)
    tracking_scores = np.full((n_tracks, n_frames), np.nan, np.float64)
    occupancy = np.zeros((n_frames, n_tracks), np.uint8)

    for lf in lfs:
        f = int(lf.frame_idx)
        if not 0 <= f < n_frames:
            continue
        for rank, inst in enumerate(lf.predicted_instances):
            t = slot(inst, rank)
            if t is None or t >= n_tracks:
                continue
            xy = inst.numpy()
            pts[t, :, :, f] = xy
            if isinstance(inst, PredictedInstance):
                point_scores[t, :, f] = np.asarray(inst.point_scores, np.float64)
                instance_scores[t, f] = float(inst.score)
                tracking_scores[t, f] = float(getattr(inst, "tracking_score", 0.0) or 0.0)
            occupancy[f, t] = 1

    edge_names = [[node_names[s], node_names[d]] for s, d in (skel.edge_inds if skel else [])]
    edge_inds = np.asarray(skel.edge_inds if skel else [], np.int64).reshape(-1, 2)

    out_path = Path(path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(str(out_path), "w") as f:
        f.create_dataset("tracks", data=pts, compression="gzip", compression_opts=1)
        f.create_dataset("track_occupancy", data=occupancy, compression="gzip", compression_opts=1)
        f.create_dataset("point_scores", data=point_scores, compression="gzip", compression_opts=1)
        f.create_dataset("instance_scores", data=instance_scores, compression="gzip", compression_opts=1)
        f.create_dataset("tracking_scores", data=tracking_scores, compression="gzip", compression_opts=1)
        f.create_dataset("node_names", data=np.array([n.encode() for n in node_names]))
        f.create_dataset(
            "track_names", data=np.array([t.encode() for t in track_names])
            if track_names else np.zeros(0, dtype="S1")
        )
        f.create_dataset(
            "edge_names",
            data=np.array([f"{a} -> {b}".encode() for a, b in edge_names])
            if edge_names else np.zeros(0, dtype="S1"),
        )
        f.create_dataset("edge_inds", data=edge_inds)
        f.create_dataset(
            "video_path",
            data=np.bytes_(str(getattr(vid, "filename", "") or "")),
        )
        f.create_dataset("video_ind", data=np.int64(video))
        f.create_dataset(
            "labels_path", data=np.bytes_(str(labels_path or ""))
        )
        f.create_dataset(
            "provenance",
            data=np.bytes_(json.dumps(getattr(labels, "provenance", {}) or {})),
        )
    return out_path


def save_analysis_h5_files(
    labels: Labels,
    slp_output_path: Union[str, Path],
    video_index: Optional[int] = None,
) -> List[Path]:
    """One Analysis HDF5 per video with predictions.

    Paths derive from ``slp_output_path`` by replacing the trailing
    ``.predictions.slp`` / ``.slp`` with ``.analysis.h5``; the video name is
    embedded when more than one video is exported, with a ``_<idx>`` suffix
    disambiguating duplicate stems. Videos with no predicted frames are
    skipped.
    """
    slp_output_path = Path(slp_output_path)
    name = slp_output_path.name
    for suffix in (".predictions.slp", ".slp"):
        if name.endswith(suffix):
            base_stem = name[: -len(suffix)]
            break
    else:
        base_stem = slp_output_path.stem
    base = slp_output_path.parent / base_stem

    frames_per_video = [0] * len(labels.videos)
    for lf in labels.labeled_frames:
        if not lf.predicted_instances:
            continue
        for i, v in enumerate(labels.videos):
            if lf.video is v:
                frames_per_video[i] += 1
                break

    if video_index is not None and not 0 <= video_index < len(labels.videos):
        # Falling back to every video would mislabel the scoped export.
        raise ValueError(
            f"video_index {video_index} out of range for "
            f"{len(labels.videos)} video(s)."
        )
    candidates = (
        [video_index] if video_index is not None
        else list(range(len(labels.videos)))
    )
    targets = [i for i in candidates if frames_per_video[i] > 0]

    def video_name(i):
        fn = getattr(labels.videos[i], "filename", None)
        return Path(fn).stem if isinstance(fn, str) else f"video_{i}"

    names = {i: video_name(i) for i in targets}
    counts = {}
    for n in names.values():
        counts[n] = counts.get(n, 0) + 1
    names = {i: (f"{n}_{i}" if counts[n] > 1 else n) for i, n in names.items()}

    written = []
    embed_name = len(targets) > 1
    for i in targets:
        h5_path = (
            base.parent / f"{base.name}.{names[i]}.analysis.h5"
            if embed_name
            else base.parent / f"{base.name}.analysis.h5"
        )
        written.append(
            save_analysis_h5(labels, h5_path, video=i, labels_path=str(slp_output_path))
        )
    return written
