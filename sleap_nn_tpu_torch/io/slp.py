"""``.slp`` (HDF5) labels file reader/writer.

Port of ``sleap_nn_tpu/io/slp.py``: the SLEAP labels container of
sleap-io (format_id 1.2), read and written through the port's own
HDF5 subset (``io/hdf5.py``), so the files are the JAX package's and no
HDF5 library is needed. Embedded
frames are PNG through ``io/png.py`` (the JAX package calls cv2). The
layout:

- ``frames``: compound (frame_id, video, frame_idx, instance_id_start/end)
- ``instances``: compound (instance_id, instance_type {0=user,1=predicted},
  frame_id, skeleton, track, from_predicted, score, point_id_start/end,
  tracking_score)
- ``points`` / ``pred_points``: compound (x, y, visible, complete[, score])
- ``videos_json`` / ``tracks_json`` / ``suggestions_json``: json byte rows
- ``metadata`` group attrs: ``format_id`` and a ``json`` blob holding the
  skeletons in SLEAP's legacy jsonpickle-flavored graph encoding
- ``videoN/video`` (+``frame_numbers``): optionally embedded encoded frames
- ``pred_masks_json`` / ``pred_masks_data``: segmentation masks, one JSON
  index row (frame, score, track, shape, scale) and one variable-length
  ``uint8`` row of ``np.packbits`` per mask, written contiguously as
  h5py writes a dataset without filters (the JAX package's extension)
- ``pred_rois_json`` / ``pred_centroids_json``: polygon ROIs and centroid
  points, JSON rows (the JAX package's extension)
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

from sleap_nn_tpu_torch.io.model import (
    Instance,
    LabeledFrame,
    Labels,
    PredictedCentroid,
    PredictedInstance,
    PredictedROI,
    SegmentationMask,
    Skeleton,
    SuggestionFrame,
    Track,
    UserCentroid,
)
from sleap_nn_tpu_torch.io import hdf5
from sleap_nn_tpu_torch.io.png import encode_png
from sleap_nn_tpu_torch.io.video import Video

_POINT_DTYPE = np.dtype(
    [("x", "<f8"), ("y", "<f8"), ("visible", "?"), ("complete", "?")]
)
_PRED_POINT_DTYPE = np.dtype(
    [("x", "<f8"), ("y", "<f8"), ("visible", "?"), ("complete", "?"), ("score", "<f8")]
)
_INSTANCE_DTYPE = np.dtype(
    [
        ("instance_id", "<i8"),
        ("instance_type", "u1"),
        ("frame_id", "<u8"),
        ("skeleton", "<u4"),
        ("track", "<i4"),
        ("from_predicted", "<i8"),
        ("score", "<f4"),
        ("point_id_start", "<u8"),
        ("point_id_end", "<u8"),
        ("tracking_score", "<f4"),
    ]
)
_FRAME_DTYPE = np.dtype(
    [
        ("frame_id", "<u8"),
        ("video", "<u4"),
        ("frame_idx", "<u8"),
        ("instance_id_start", "<u8"),
        ("instance_id_end", "<u8"),
    ]
)


# ---------------------------------------------------------------------------
# Skeleton (de)serialization — SLEAP legacy jsonpickle graph encoding
# ---------------------------------------------------------------------------

_EDGE_BODY = 1
_EDGE_SYMMETRY = 2


def _decode_skeletons(metadata: dict) -> List[Skeleton]:
    """Decode skeletons from the metadata json blob.

    Handles the jsonpickle conventions found in real files: node ids given
    as ints (indices into the global ``nodes`` list) or ``{"py/id": k}``
    back-references, and edge types given as ``py/reduce`` on first
    occurrence then ``py/id`` references (1 = body edge, 2 = symmetry).
    """
    global_nodes = [n["name"] for n in metadata.get("nodes", [])]
    skeletons = []
    for skel_json in metadata.get("skeletons", []):
        # jsonpickle memoizes objects; track memo ids for nodes + edge types.
        edge_type_memo: dict = {}
        memo_counter = [0]

        def resolve_id(v):
            if isinstance(v, dict) and "py/id" in v:
                return v["py/id"]
            return v

        def decode_edge_type(t) -> int:
            if t is None:
                return _EDGE_BODY
            if isinstance(t, dict):
                if "py/reduce" in t:
                    val = t["py/reduce"][1]["py/tuple"][0]
                    memo_counter[0] += 1
                    edge_type_memo[memo_counter[0]] = val
                    return val
                if "py/id" in t:
                    return edge_type_memo.get(t["py/id"], _EDGE_BODY)
            return _EDGE_BODY

        graph = skel_json.get("graph", {})
        name = graph.get("name", "Skeleton-0")

        # Node order within the skeleton = order of graph["nodes"]; each id
        # indexes the global node-name list.
        node_ids = []
        for n in skel_json.get("nodes", []):
            nid = resolve_id(n.get("id"))
            if isinstance(nid, dict):
                nid = nid.get("py/id", 0)
            node_ids.append(int(nid))
        node_names = [global_nodes[i] for i in node_ids]
        id_to_local = {gid: local for local, gid in enumerate(node_ids)}

        edges, symmetries = [], []
        seen_sym = set()
        for link in skel_json.get("links", []):
            etype = decode_edge_type(link.get("type"))
            src = id_to_local.get(int(resolve_id(link["source"])))
            dst = id_to_local.get(int(resolve_id(link["target"])))
            if src is None or dst is None:
                continue
            if etype == _EDGE_SYMMETRY:
                key = frozenset((src, dst))
                if key not in seen_sym:
                    seen_sym.add(key)
                    symmetries.append((src, dst))
            else:
                edges.append((src, dst))
        skeletons.append(
            Skeleton(nodes=node_names, edges=edges, symmetries=symmetries, name=name)
        )
    return skeletons


def _encode_skeletons(skeletons: List[Skeleton]):
    """Encode skeletons into (skeletons_json, global_nodes_json)."""
    global_names: List[str] = []
    for skel in skeletons:
        for n in skel.node_names:
            if n not in global_names:
                global_names.append(n)
    nodes_json = [{"name": n, "weight": 1.0} for n in global_names]

    skels_json = []
    for skel in skeletons:
        node_gids = [global_names.index(n) for n in skel.node_names]
        links = []
        memo_count = 0
        body_id = sym_id = None
        insert_idx = 0

        def edge_type_json(val):
            nonlocal memo_count, body_id, sym_id
            if val == _EDGE_BODY:
                if body_id is None:
                    memo_count += 1
                    body_id = memo_count
                    return {
                        "py/reduce": [
                            {"py/type": "sleap.skeleton.EdgeType"},
                            {"py/tuple": [1]},
                        ]
                    }
                return {"py/id": body_id}
            if sym_id is None:
                memo_count += 1
                sym_id = memo_count
                return {
                    "py/reduce": [
                        {"py/type": "sleap.skeleton.EdgeType"},
                        {"py/tuple": [2]},
                    ]
                }
            return {"py/id": sym_id}

        for (s, d) in skel.edge_inds:
            links.append(
                {
                    "edge_insert_idx": insert_idx,
                    "key": 0,
                    "source": node_gids[s],
                    "target": node_gids[d],
                    "type": edge_type_json(_EDGE_BODY),
                }
            )
            insert_idx += 1
        for (s, d) in skel.symmetry_inds:
            for a, b in ((s, d), (d, s)):
                links.append(
                    {
                        "key": 0,
                        "source": node_gids[a],
                        "target": node_gids[b],
                        "type": edge_type_json(_EDGE_SYMMETRY),
                    }
                )
        skels_json.append(
            {
                "directed": True,
                "graph": {"name": skel.name, "num_edges_inserted": insert_idx},
                "links": links,
                "multigraph": True,
                "nodes": [{"id": gid} for gid in node_gids],
            }
        )
    return skels_json, nodes_json


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------


def load_slp(path: Union[str, Path], open_videos: bool = True) -> Labels:
    """Read a ``.slp`` labels file."""
    path = str(path)
    with hdf5.File(path, "r") as f:
        metadata = json.loads(f["metadata"].attrs["json"])
        skeletons = _decode_skeletons(metadata)

        videos = []
        if "videos_json" in f:
            for row in f["videos_json"][:]:
                spec = json.loads(row)
                videos.append(Video.from_backend_json(spec, slp_path=path))

        tracks = []
        if "tracks_json" in f and f["tracks_json"].shape[0] and f["tracks_json"].dtype != np.float64:
            for row in f["tracks_json"][:]:
                spawned_on, name = json.loads(row)
                tracks.append(Track(name=str(name), spawned_on=int(spawned_on)))

        points = f["points"][:] if "points" in f else np.zeros(0, dtype=_POINT_DTYPE)
        pred_points = (
            f["pred_points"][:] if "pred_points" in f else np.zeros(0, dtype=_PRED_POINT_DTYPE)
        )
        instances_ds = f["instances"][:] if "instances" in f else np.zeros(0, dtype=_INSTANCE_DTYPE)
        frames_ds = f["frames"][:] if "frames" in f else np.zeros(0, dtype=_FRAME_DTYPE)
        mask_meta = f["pred_masks_json"][:] if "pred_masks_json" in f else []
        mask_blobs = f["pred_masks_data"][:] if "pred_masks_data" in f else []
        roi_rows = f["pred_rois_json"][:] if "pred_rois_json" in f else []
        cent_rows = f["pred_centroids_json"][:] if "pred_centroids_json" in f else []
        sugg_rows = []
        if "suggestions_json" in f and f["suggestions_json"].shape[0]                 and f["suggestions_json"].dtype != np.float64:
            sugg_rows = [json.loads(r) for r in f["suggestions_json"][:]]

    # Build instance objects indexed by instance_id.
    inst_by_id = {}
    from_predicted_pairs = []
    for rec in instances_ds:
        skel = skeletons[int(rec["skeleton"])] if skeletons else Skeleton()
        track = tracks[int(rec["track"])] if int(rec["track"]) >= 0 else None
        i0, i1 = int(rec["point_id_start"]), int(rec["point_id_end"])
        if int(rec["instance_type"]) == 0:
            pts = points[i0:i1]
            inst = Instance(
                points=np.stack([pts["x"], pts["y"]], axis=-1),
                skeleton=skel,
                track=track,
                visible=pts["visible"],
                complete=pts["complete"],
            )
        else:
            pts = pred_points[i0:i1]
            inst = PredictedInstance(
                points=np.stack([pts["x"], pts["y"]], axis=-1),
                skeleton=skel,
                point_scores=pts["score"],
                score=float(rec["score"]),
                track=track,
                # format_id 1.1 predictions predate the tracking_score
                # column: default 0.0, as sleap-io does.
                tracking_score=(
                    float(rec["tracking_score"])
                    if "tracking_score" in (rec.dtype.names or ())
                    else 0.0
                ),
                visible=pts["visible"],
            )
        inst_by_id[int(rec["instance_id"])] = inst
        if int(rec["from_predicted"]) >= 0:
            from_predicted_pairs.append((inst, int(rec["from_predicted"])))
    for inst, src_id in from_predicted_pairs:
        inst.from_predicted = inst_by_id.get(src_id)

    labeled_frames = []
    for rec in frames_ds:
        video = videos[int(rec["video"])] if videos else None
        insts = [
            inst_by_id[i]
            for i in range(int(rec["instance_id_start"]), int(rec["instance_id_end"]))
            if i in inst_by_id
        ]
        labeled_frames.append(
            LabeledFrame(video=video, frame_idx=int(rec["frame_idx"]), instances=insts)
        )

    # Re-attach the masks, polygon ROIs and centroid points (save_slp's
    # extensions).
    for meta_row, blob in zip(mask_meta, mask_blobs):
        meta = json.loads(meta_row)
        fi = int(meta["frame"])
        if not 0 <= fi < len(labeled_frames):
            continue
        h, w = meta["shape"]
        mask = np.unpackbits(np.asarray(blob, np.uint8), count=h * w).reshape(h, w)
        ti = int(meta.get("track", -1))
        labeled_frames[fi].masks.append(SegmentationMask(
            mask=mask.astype(bool),
            score=float(meta.get("score", 0.0)),
            track=tracks[ti] if 0 <= ti < len(tracks) else None,
            scale=float(meta.get("scale", 1.0)),
        ))
    for row in roi_rows:
        meta = json.loads(row)
        fi = int(meta["frame"])
        if not 0 <= fi < len(labeled_frames):
            continue
        ti = int(meta.get("track", -1))
        labeled_frames[fi].rois.append(PredictedROI(
            points=np.asarray(meta["points"], float),
            score=float(meta.get("score", 0.0)),
            track=tracks[ti] if 0 <= ti < len(tracks) else None,
        ))
    for row in cent_rows:
        meta = json.loads(row)
        fi = int(meta["frame"])
        if not 0 <= fi < len(labeled_frames):
            continue
        ti = int(meta.get("track", -1))
        track = tracks[ti] if 0 <= ti < len(tracks) else None
        if meta.get("kind") == "user":
            labeled_frames[fi].centroids.append(UserCentroid(
                point=np.asarray(meta["point"], float), track=track,
            ))
        else:
            labeled_frames[fi].centroids.append(PredictedCentroid(
                point=np.asarray(meta["point"], float),
                score=float(meta.get("score", 0.0)),
                track=track,
            ))

    suggestions = []
    for row in sugg_rows:
        vi = int(row.get("video", 0))
        suggestions.append(
            SuggestionFrame(
                video=videos[vi] if 0 <= vi < len(videos) else None,
                frame_idx=int(row.get("frame_idx", row.get("frame_id", 0))),
                group=int(row.get("group") or 0),
            )
        )

    labels = Labels(
        labeled_frames=labeled_frames,
        videos=videos,
        skeletons=skeletons,
        tracks=tracks,
        provenance=metadata.get("provenance", {}),
        suggestions=suggestions,
    )
    return labels


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------


def _video_json(video) -> dict:
    """A video's ``videos_json`` row: a port ``Video`` gives its own; any
    other frame source is recorded as a media file of its ``filename``."""
    if isinstance(video, Video):
        return video.to_backend_json()
    return {"backend": {"filename": str(getattr(video, "filename", "")), "grayscale": None,
                        "bgr": True, "dataset": "", "input_format": ""}}


def save_slp(path: Union[str, Path], labels: Labels, embed: bool = False):
    """Write a ``.slp`` labels file (sleap-io format_id 1.2 layout)."""
    path = str(path)
    parent = Path(path).parent
    if str(parent) not in ("", "."):
        parent.mkdir(parents=True, exist_ok=True)
    skeletons = labels.skeletons or [Skeleton()]
    skel_idx = {id(s): i for i, s in enumerate(skeletons)}
    track_idx = {id(t): i for i, t in enumerate(labels.tracks)}
    video_idx = {id(v): i for i, v in enumerate(labels.videos)}

    points_rows, pred_points_rows = [], []
    instance_rows, frame_rows = [], []
    inst_id_of = {}

    inst_id = 0
    for lf in labels.labeled_frames:
        for inst in lf.instances:
            inst_id_of[id(inst)] = inst_id
            inst_id += 1

    inst_id = 0
    for frame_id, lf in enumerate(labels.labeled_frames):
        inst_start = inst_id
        for inst in lf.instances:
            is_pred = isinstance(inst, PredictedInstance)
            n = len(inst.skeleton)
            if is_pred:
                p0 = len(pred_points_rows)
                for k in range(n):
                    pred_points_rows.append(
                        (
                            inst.points[k, 0],
                            inst.points[k, 1],
                            bool(inst.visible[k]),
                            bool(inst.complete[k]) if k < len(inst.complete) else False,
                            float(inst.point_scores[k]),
                        )
                    )
                p1 = len(pred_points_rows)
            else:
                p0 = len(points_rows)
                for k in range(n):
                    points_rows.append(
                        (
                            inst.points[k, 0],
                            inst.points[k, 1],
                            bool(inst.visible[k]),
                            bool(inst.complete[k]) if k < len(inst.complete) else False,
                        )
                    )
                p1 = len(points_rows)
            from_pred = (
                inst_id_of.get(id(inst.from_predicted), -1)
                if getattr(inst, "from_predicted", None) is not None
                else -1
            )
            instance_rows.append(
                (
                    inst_id,
                    1 if is_pred else 0,
                    frame_id,
                    skel_idx.get(id(inst.skeleton), 0),
                    track_idx.get(id(inst.track), -1) if inst.track is not None else -1,
                    from_pred,
                    float(getattr(inst, "score", np.nan)) if is_pred else np.nan,
                    p0,
                    p1,
                    float(getattr(inst, "tracking_score", np.nan)) if is_pred else np.nan,
                )
            )
            inst_id += 1
        frame_rows.append(
            (
                frame_id,
                video_idx.get(id(lf.video), 0),
                lf.frame_idx,
                inst_start,
                inst_id,
            )
        )

    skels_json, nodes_json = _encode_skeletons(skeletons)
    metadata = {
        "version": "2.0.0",
        "skeletons": skels_json,
        "nodes": nodes_json,
        "videos": [],
        "tracks": [],
        "suggestions": [],
        "negative_anchors": {},
        "provenance": labels.provenance,
    }

    with hdf5.File(path, "w") as f:
        # Optionally embed frames referenced by labeled frames.
        videos_json_rows = []
        for vi, video in enumerate(labels.videos):
            if embed and video is not None:
                frame_idxs = sorted(
                    {lf.frame_idx for lf in labels.labeled_frames if lf.video is video}
                )
                grp = f.create_group(f"video{vi}")
                imgs = np.empty(len(frame_idxs), dtype=hdf5.vlen_dtype(np.uint8))
                for k, i in enumerate(frame_idxs):
                    imgs[k] = np.frombuffer(encode_png(video[i]), dtype=np.uint8)
                ds = grp.create_dataset("video", data=imgs)
                shape = video.shape
                ds.attrs["format"] = "png"
                ds.attrs["channels"] = shape[3] if shape else 1
                ds.attrs["height"] = shape[1] if shape else 0
                ds.attrs["width"] = shape[2] if shape else 0
                grp.create_dataset("frame_numbers", data=np.asarray(frame_idxs, dtype=np.int64))
                src = grp.create_group("source_video")
                src.attrs["json"] = json.dumps(_video_json(video))
                videos_json_rows.append(
                    json.dumps(
                        {
                            "backend": {
                                "filename": ".",
                                "dataset": f"video{vi}/video",
                                "input_format": "channels_last",
                                "convert_range": False,
                            }
                        }
                    )
                )
            else:
                spec = _video_json(video) if video is not None else {"backend": {}}
                videos_json_rows.append(json.dumps(spec))

        f.create_dataset(
            "videos_json", data=np.array([r.encode() for r in videos_json_rows])
        ) if videos_json_rows else f.create_dataset("videos_json", data=np.zeros(0))
        tracks_rows = [
            json.dumps([t.spawned_on, t.name]).encode() for t in labels.tracks
        ]
        if tracks_rows:
            f.create_dataset("tracks_json", data=np.array(tracks_rows))
        else:
            f.create_dataset("tracks_json", data=np.zeros(0))
        sugg = getattr(labels, "suggestions", None) or []
        if sugg:
            rows = [
                json.dumps(
                    {
                        "video": str(video_idx.get(id(s_.video), 0)),
                        "frame_idx": int(s_.frame_idx),
                        "group": int(s_.group),
                    }
                ).encode()
                for s_ in sugg
            ]
            f.create_dataset("suggestions_json", data=np.array(rows))
        else:
            f.create_dataset("suggestions_json", data=np.zeros(0))

        md = f.create_group("metadata")
        md.attrs["format_id"] = 1.2
        md.attrs["json"] = np.bytes_(json.dumps(metadata, separators=(",", ":")))

        f.create_dataset("points", data=np.array(points_rows, dtype=_POINT_DTYPE))
        f.create_dataset(
            "pred_points", data=np.array(pred_points_rows, dtype=_PRED_POINT_DTYPE)
        )
        f.create_dataset(
            "instances", data=np.array(instance_rows, dtype=_INSTANCE_DTYPE)
        )
        f.create_dataset("frames", data=np.array(frame_rows, dtype=_FRAME_DTYPE))

        # Masks, polygon ROIs and centroid points: extensions that readers
        # which do not know them ignore. A mask is one JSON index row and
        # one row of its packed bits.
        mask_meta, mask_blobs = [], []
        for fi, lf in enumerate(labels.labeled_frames):
            for sm in getattr(lf, "masks", []) or []:
                m = np.asarray(sm.mask, bool)
                mask_meta.append(json.dumps({
                    "frame": fi,
                    "score": float(sm.score),
                    "track": track_idx.get(id(sm.track), -1),
                    "shape": [int(m.shape[0]), int(m.shape[1])],
                    "scale": float(getattr(sm, "scale", 1.0)),
                }).encode())
                mask_blobs.append(np.packbits(m))
        if mask_meta:
            f.create_dataset("pred_masks_json", data=np.array(mask_meta))
            blobs = np.empty(len(mask_blobs), dtype=hdf5.vlen_dtype(np.uint8))
            for i, b in enumerate(mask_blobs):
                blobs[i] = b
            f.create_dataset("pred_masks_data", data=blobs)
        roi_meta = []
        for fi, lf in enumerate(labels.labeled_frames):
            for roi in getattr(lf, "rois", []) or []:
                roi_meta.append(json.dumps({
                    "frame": fi,
                    "score": float(roi.score),
                    "track": track_idx.get(id(roi.track), -1),
                    "points": np.asarray(roi.points, float).tolist(),
                }).encode())
        if roi_meta:
            f.create_dataset("pred_rois_json", data=np.array(roi_meta))
        cent_meta = []
        for fi, lf in enumerate(labels.labeled_frames):
            for c in getattr(lf, "centroids", []) or []:
                cent_meta.append(json.dumps({
                    "frame": fi,
                    "score": float(c.score),
                    "track": track_idx.get(id(c.track), -1),
                    "point": np.asarray(c.point, float).tolist(),
                    # user-annotated centroids (pure-centroid seeding) are
                    # distinguished from predicted ones on reload.
                    "kind": "user" if isinstance(c, UserCentroid) else "predicted",
                }).encode())
        if cent_meta:
            f.create_dataset("pred_centroids_json", data=np.array(cent_meta))
