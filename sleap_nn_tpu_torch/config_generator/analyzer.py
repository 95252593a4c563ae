"""Dataset statistics for the config generator.

Port of ``sleap_nn_tpu/config_generator/analyzer.py``, on the port's
``io/`` and ``tracking/utils.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from sleap_nn_tpu_torch.io.model import Labels
from sleap_nn_tpu_torch.tracking.utils import compute_iou, get_bbox


@dataclasses.dataclass
class DatasetStats:
    """Statistics extracted from an SLP file (reference: analyzer.py:28)."""

    slp_path: str
    num_labeled_frames: int = 0
    num_videos: int = 0
    max_height: int = 0
    max_width: int = 0
    num_channels: int = 1
    max_instances_per_frame: int = 0
    avg_instances_per_frame: float = 0.0
    max_bbox_size: float = 0.0
    avg_bbox_size: float = 0.0
    avg_bbox_diagonal: float = 0.0
    num_nodes: int = 0
    num_edges: int = 0
    node_names: List[str] = dataclasses.field(default_factory=list)
    edges: List[Tuple[str, str]] = dataclasses.field(default_factory=list)
    has_tracks: bool = False
    num_tracks: int = 0
    estimated_total_bytes: int = 0
    overlap_frequency: float = 0.0
    node_visibility: Dict[str, float] = dataclasses.field(default_factory=dict)
    view_type: str = "unknown"  # "top" | "side" | "unknown"

    @property
    def is_multi_instance(self) -> bool:
        return self.max_instances_per_frame > 1

    @property
    def is_single_instance(self) -> bool:
        return self.max_instances_per_frame <= 1


def analyze_slp(path, labels: Optional[Labels] = None) -> DatasetStats:
    """Extract dataset statistics for recommendation (reference: analyzer.py:431)."""
    if labels is None:
        from sleap_nn_tpu_torch.io.slp import load_slp

        labels = load_slp(path)

    stats = DatasetStats(slp_path=str(path))
    user_lfs = labels.user_labeled_frames or labels.labeled_frames
    stats.num_labeled_frames = len(user_lfs)
    stats.num_videos = len(labels.videos)

    h = w = c = 0
    for video in labels.videos:
        shape = video.shape
        if shape is not None:
            h, w, c = max(h, shape[1]), max(w, shape[2]), max(c, shape[3])
    if h == 0 and user_lfs:
        img = user_lfs[0].image
        h, w, c = img.shape[0], img.shape[1], img.shape[2]
    stats.max_height, stats.max_width, stats.num_channels = h, w, max(c, 1)

    if labels.skeletons:
        skel = labels.skeleton
        stats.num_nodes = len(skel.node_names)
        stats.num_edges = len(skel.edge_inds)
        stats.node_names = list(skel.node_names)
        stats.edges = list(skel.edge_names)

    stats.has_tracks = len(labels.tracks) > 0
    stats.num_tracks = len(labels.tracks)

    counts, sizes, diags = [], [], []
    n_overlap_frames = 0
    visibility = {n: 0 for n in stats.node_names}
    for lf in user_lfs:
        insts = [i for i in lf.instances if not i.is_empty()]
        counts.append(len(insts))
        boxes = []
        for inst in insts:
            pts = inst.numpy()
            wdt = np.nanmax(pts[:, 0]) - np.nanmin(pts[:, 0])
            hgt = np.nanmax(pts[:, 1]) - np.nanmin(pts[:, 1])
            if np.isfinite(wdt) and np.isfinite(hgt):
                sizes.append(max(wdt, hgt))
                diags.append(float(np.hypot(wdt, hgt)))
                boxes.append(get_bbox(inst))
            for k, name in enumerate(stats.node_names[: pts.shape[0]]):
                if not np.isnan(pts[k]).any():
                    visibility[name] += 1
        # Overlap: any instance pair with bbox IoU > 0.2.
        overlapping = any(
            compute_iou(boxes[i], boxes[j]) > 0.2
            for i in range(len(boxes))
            for j in range(i + 1, len(boxes))
        )
        n_overlap_frames += int(overlapping)

    if counts:
        stats.max_instances_per_frame = int(max(counts))
        stats.avg_instances_per_frame = float(np.mean(counts))
        stats.overlap_frequency = n_overlap_frames / len(counts)
    if sizes:
        stats.max_bbox_size = float(max(sizes))
        stats.avg_bbox_size = float(np.mean(sizes))
        stats.avg_bbox_diagonal = float(np.mean(diags))
    if stats.num_labeled_frames:
        stats.node_visibility = {
            n: 100.0 * v / (stats.num_labeled_frames * max(stats.avg_instances_per_frame, 1))
            for n, v in visibility.items()
        }
    stats.estimated_total_bytes = stats.num_labeled_frames * h * w * stats.num_channels

    # View-type heuristic: symmetric L/R node names suggest side/top ambiguity;
    # tracks of rotation-invariant animals usually mean top view.
    names = " ".join(stats.node_names).lower()
    if any(k in names for k in ("left", "right", "_l ", "_r ")):
        stats.view_type = "side"
    elif stats.is_multi_instance:
        stats.view_type = "top"
    return stats
