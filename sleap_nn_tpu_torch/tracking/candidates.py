"""Candidate stores for tracking.

Port of ``sleap_nn_tpu/tracking/candidates.py``: the fixed window of the
last N tracked frames and the per-track local queues, with their
``TrackInstance`` and ``TrackedInstanceFeature`` records.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict, deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np

from sleap_nn_tpu_torch.tracking.utils import count_valid_points


@dataclasses.dataclass
class TrackInstance:
    """One detection with its feature and (eventually) a track id."""

    src_instance: Any
    feature: np.ndarray
    track_id: Optional[int] = None
    tracking_score: float = 0.0
    frame_idx: int = 0
    image: Optional[np.ndarray] = None


@dataclasses.dataclass
class TrackedInstanceFeature:
    """A historical candidate feature for scoring."""

    feature: np.ndarray
    src_predicted_instance: Any
    frame_idx: int
    tracking_score: float = 0.0
    shifted_keypoints: Optional[np.ndarray] = None


class FixedWindowCandidates:
    """Deque of the last N tracked frames."""

    def __init__(self, window_size: int = 5, min_new_track_points: int = 0):
        self.window_size = window_size
        self.min_new_track_points = min_new_track_points
        self.tracker_queue: Deque[List[TrackInstance]] = deque(maxlen=window_size)
        self._next_track_id = 0

    @property
    def current_tracks(self) -> List[int]:
        tracks = []
        for frame in self.tracker_queue:
            for ti in frame:
                if ti.track_id is not None and ti.track_id not in tracks:
                    tracks.append(ti.track_id)
        return sorted(tracks)

    def make_instances(self, features, instances, frame_idx, image=None) -> List[TrackInstance]:
        return [
            TrackInstance(src_instance=inst, feature=f, frame_idx=frame_idx, image=image)
            for f, inst in zip(features, instances)
        ]

    def get_features_from_track_id(self, track_id: int) -> List[TrackedInstanceFeature]:
        out = []
        for frame in self.tracker_queue:
            for ti in frame:
                if ti.track_id == track_id:
                    out.append(
                        TrackedInstanceFeature(
                            ti.feature, ti.src_instance, ti.frame_idx, ti.tracking_score
                        )
                    )
        return out

    def get_new_track_id(self) -> int:
        tid = self._next_track_id
        self._next_track_id += 1
        return tid

    def add_new_tracks(self, instances: List[TrackInstance]) -> List[TrackInstance]:
        for ti in instances:
            if count_valid_points(ti.src_instance) >= self.min_new_track_points:
                ti.track_id = self.get_new_track_id()
                ti.tracking_score = 1.0
        self.tracker_queue.append(instances)
        return instances

    def update_tracks(self, instances, row_inds, col_inds, tracking_scores) -> List[TrackInstance]:
        tracks = self.current_tracks
        for r, c, s in zip(row_inds, col_inds, tracking_scores):
            instances[r].track_id = tracks[c]
            instances[r].tracking_score = float(s)
        # Unmatched instances spawn new tracks (subject to min points).
        for ti in instances:
            if ti.track_id is None and count_valid_points(ti.src_instance) >= self.min_new_track_points:
                ti.track_id = self.get_new_track_id()
                ti.tracking_score = 1.0
        self.tracker_queue.append(instances)
        return instances


class LocalQueueCandidates:
    """Per-track deques with a max-tracks cap."""

    def __init__(
        self,
        window_size: int = 5,
        max_tracks: Optional[int] = None,
        min_new_track_points: int = 0,
    ):
        self.window_size = window_size
        self.max_tracks = max_tracks
        self.min_new_track_points = min_new_track_points
        self.tracker_queue: Dict[int, Deque[TrackInstance]] = defaultdict(
            lambda: deque(maxlen=window_size)
        )
        self._next_track_id = 0

    @property
    def current_tracks(self) -> List[int]:
        return sorted(t for t, q in self.tracker_queue.items() if len(q))

    def make_instances(self, features, instances, frame_idx, image=None) -> List[TrackInstance]:
        return [
            TrackInstance(src_instance=inst, feature=f, frame_idx=frame_idx, image=image)
            for f, inst in zip(features, instances)
        ]

    def get_features_from_track_id(self, track_id: int) -> List[TrackedInstanceFeature]:
        return [
            TrackedInstanceFeature(ti.feature, ti.src_instance, ti.frame_idx, ti.tracking_score)
            for ti in self.tracker_queue.get(track_id, [])
        ]

    def get_new_track_id(self) -> Optional[int]:
        if self.max_tracks is not None and len(self.tracker_queue) >= self.max_tracks:
            return None
        tid = self._next_track_id
        self._next_track_id += 1
        return tid

    def add_new_tracks(self, instances: List[TrackInstance]) -> List[TrackInstance]:
        for ti in instances:
            if count_valid_points(ti.src_instance) >= self.min_new_track_points:
                tid = self.get_new_track_id()
                if tid is not None:
                    ti.track_id = tid
                    ti.tracking_score = 1.0
                    self.tracker_queue[tid].append(ti)
        return instances

    def update_tracks(self, instances, row_inds, col_inds, tracking_scores) -> List[TrackInstance]:
        tracks = self.current_tracks
        for r, c, s in zip(row_inds, col_inds, tracking_scores):
            tid = tracks[c]
            instances[r].track_id = tid
            instances[r].tracking_score = float(s)
            self.tracker_queue[tid].append(instances[r])
        for ti in instances:
            if ti.track_id is None and count_valid_points(ti.src_instance) >= self.min_new_track_points:
                tid = self.get_new_track_id()
                if tid is not None:
                    ti.track_id = tid
                    ti.tracking_score = 1.0
                    self.tracker_queue[tid].append(ti)
        return instances
