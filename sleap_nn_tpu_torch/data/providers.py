"""Host-side sample extraction from labeled frames.

Port of ``sleap_nn_tpu/data/providers.py`` (numpy, channel-last).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from sleap_nn_tpu_torch.io.model import LabeledFrame, Labels, PredictedInstance


def get_max_instances(labels: Labels, include_user_centroids: bool = False) -> int:
    """Max number of instances in any labeled frame (1 for no frames).

    ``include_user_centroids`` (centroid models) also counts user-centroid
    records, each of which becomes one training instance.
    """

    def count(lf):
        n = len(lf.instances)
        if include_user_centroids:
            n = max(n, len(lf.user_centroids))
        return n

    return max((count(lf) for lf in labels.labeled_frames), default=1)


def get_max_height_width(labels: Labels) -> Tuple[int, int]:
    """Max (height, width) over the labels' videos (the first frame's if no
    video reports a shape)."""
    h = w = 0
    for video in labels.videos:
        shape = getattr(video, "shape", None)
        if shape is not None:
            h = max(h, shape[1])
            w = max(w, shape[2])
    if h == 0 or w == 0:
        img = labels.labeled_frames[0].image
        h, w = img.shape[0], img.shape[1]
    return h, w


def filter_oob_points(points: np.ndarray, img_height: int, img_width: int) -> np.ndarray:
    """NaN-out keypoints outside [0, W) x [0, H) (annotation errors)."""
    points = points.copy()
    x, y = points[..., 0], points[..., 1]
    oob = (x < 0) | (x >= img_width) | (y < 0) | (y >= img_height)
    points[oob] = np.nan
    return points


def process_lf(
    lf: LabeledFrame,
    video_idx: int,
    max_instances: int,
    user_instances_only: bool = True,
    image: Optional[np.ndarray] = None,
    track_index: Optional[dict] = None,
) -> Optional[Dict[str, Any]]:
    """LabeledFrame -> sample dict, or None when no usable instance remains.

    Keys: ``image`` uint8 (H, W, C); ``instances`` float32
    (max_instances, n_nodes, 2) NaN-padded; ``num_instances`` int;
    ``frame_idx``/``video_idx`` int; ``orig_size`` (2,) [h, w]; ``track_ids``
    int32 (max_instances,) (-1 = untracked/padding), looked up in
    ``track_index`` (``id(track) -> class idx``) when it is given.
    """
    instances_list = list(lf.instances)
    if user_instances_only:
        user = [i for i in instances_list if not isinstance(i, PredictedInstance)]
        if user:
            instances_list = user

    img = image if image is not None else lf.image
    if img.ndim == 2:
        img = img[..., None]
    img_height, img_width = img.shape[:2]

    pts_list, tid_list = [], []
    for inst in instances_list:
        if inst.is_empty():
            continue
        pts = filter_oob_points(inst.numpy().astype(np.float32), img_height, img_width)
        if np.isnan(pts).all():
            continue
        pts_list.append(pts)
        tid = -1
        if track_index is not None and inst.track is not None:
            tid = track_index.get(id(inst.track), -1)
        tid_list.append(tid)
    if not pts_list:
        return None

    n_nodes = pts_list[0].shape[0]
    num_instances = min(len(pts_list), max_instances)
    instances = np.full((max_instances, n_nodes, 2), np.nan, dtype=np.float32)
    instances[:num_instances] = np.stack(pts_list)[:num_instances]
    track_ids = np.full((max_instances,), -1, dtype=np.int32)
    track_ids[:num_instances] = np.asarray(tid_list[:num_instances], dtype=np.int32)

    return {
        "image": np.ascontiguousarray(img),
        "instances": instances,
        "num_instances": num_instances,
        "frame_idx": int(lf.frame_idx),
        "video_idx": int(video_idx),
        "orig_size": np.array([img_height, img_width], dtype=np.float32),
        "track_ids": track_ids,
    }
