"""Trackers: base (feature scoring + assignment), flow-shift, Kalman-shift.

Port of ``sleap_nn_tpu/tracking/tracker.py``: the candidate / score /
assign architecture, optical-flow candidate shifting (OpenCV's
Lucas-Kanade, imported inside ``FlowShiftTracker._compute_optical_flow``:
without cv2 that tracker raises ``ImportError``) and per-track EM-fit
constant-velocity Kalman prediction (``tracking/kalman.py``), with
``connect_single_breaks`` and ``run_tracker``. With ``features="masks"``
a frame's ``SegmentationMask``s are tracked (scored by ``mask_iou``) and
carry the tracks.
"""

from __future__ import annotations

import functools
import warnings
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

from sleap_nn_tpu_torch.io.model import Labels, PredictedInstance, Track
from sleap_nn_tpu_torch.tracking.kalman import KalmanFilter
from sleap_nn_tpu_torch.tracking.candidates import (
    FixedWindowCandidates,
    LocalQueueCandidates,
    TrackedInstanceFeature,
)
from sleap_nn_tpu_torch.tracking.utils import (
    compute_cosine_sim,
    compute_euclidean_distance,
    compute_iou,
    compute_mask_iou,
    compute_oks_score,
    count_valid_points,
    cull_frame_instances,
    cull_instances,
    get_bbox,
    get_centroid,
    get_keypoints,
    get_mask,
    greedy_matching,
    hungarian_matching,
)


class Tracker:
    """Pose tracker: features -> candidate scoring -> assignment."""

    def __init__(
        self,
        candidate=None,
        min_match_points: int = 0,
        features: str = "keypoints",
        scoring_method: str = "oks",
        scoring_reduction: str = "mean",
        track_matching_method: str = "hungarian",
        robust_best_instance: float = 1.0,
        oks_stddev: float = 0.025,
        tracking_target_instance_count: Optional[int] = None,
        tracking_pre_cull_to_target: int = 0,
        tracking_pre_cull_iou_threshold: float = 0,
    ):
        self.candidate = candidate or FixedWindowCandidates()
        self.is_local_queue = isinstance(self.candidate, LocalQueueCandidates)
        self.min_match_points = min_match_points
        self.features = features
        self.scoring_method = scoring_method
        self.scoring_reduction = scoring_reduction
        self.track_matching_method = track_matching_method
        self.robust_best_instance = robust_best_instance
        self.oks_stddev = oks_stddev
        self.tracking_target_instance_count = tracking_target_instance_count
        self.tracking_pre_cull_to_target = tracking_pre_cull_to_target
        self.tracking_pre_cull_iou_threshold = tracking_pre_cull_iou_threshold
        self._track_objects: Dict[int, Track] = {}

    _feature_methods = {
        "keypoints": get_keypoints,
        "centroids": get_centroid,
        "bboxes": get_bbox,
        "masks": get_mask,
    }
    _matching_methods = {"hungarian": hungarian_matching, "greedy": greedy_matching}

    @classmethod
    def from_config(
        cls,
        window_size: int = 5,
        min_new_track_points: int = 0,
        candidates_method: str = "fixed_window",
        min_match_points: int = 0,
        features: str = "keypoints",
        scoring_method: str = "oks",
        scoring_reduction: str = "mean",
        robust_best_instance: float = 1.0,
        track_matching_method: str = "hungarian",
        max_tracks: Optional[int] = None,
        use_flow: bool = False,
        use_kalman: bool = False,
        oks_stddev: Optional[float] = None,
        tracking_target_instance_count: Optional[int] = None,
        tracking_pre_cull_to_target: int = 0,
        tracking_pre_cull_iou_threshold: float = 0,
        of_img_scale: float = 1.0,
        of_window_size: int = 21,
        of_max_levels: int = 3,
        kf_track_features: str = "centroid",
        kf_init_frame_count: int = 10,
        kf_node_indices: Optional[List[int]] = None,
        kf_reset_gap_size: int = 5,
        kf_prediction_blend: float = 0.5,
        kf_gate_step_mult: float = 8.0,
        kf_min_gate_px: float = 40.0,
        kf_velocity_cap_mult: float = 3.0,
        kf_min_velocity_cap_px: float = 15.0,
        **flow_kwargs,
    ) -> "Tracker":
        """Build a tracker from config knobs.

        ``max_tracks`` auto-switches to local-queue candidates. ``oks_stddev``
        left unset auto-resolves to 0.1 for ``use_kalman`` +
        ``kf_track_features="keypoints"`` (per-node Kalman predictions are
        noisier than detections) and 0.025 otherwise.
        """
        if use_kalman and kf_track_features not in ("centroid", "keypoints"):
            raise ValueError(
                f"Invalid kf_track_features={kf_track_features!r}; "
                "choose 'centroid' or 'keypoints'."
            )
        if use_kalman and use_flow:
            raise ValueError(
                "`use_kalman` and `use_flow` are mutually exclusive; choose "
                "one tracker (Kalman tracking does not use optical flow)."
            )
        if use_kalman and tracking_target_instance_count is None and max_tracks is None:
            # The motion model needs a known identity count.
            raise ValueError(
                "Kalman tracking requires a known target identity count: pass "
                "`tracking_target_instance_count` (or `max_tracks` / "
                "`--max_instances`)."
            )
        if oks_stddev is None:
            oks_stddev = 0.1 if (use_kalman and kf_track_features == "keypoints") else 0.025
        if max_tracks is not None or candidates_method == "local_queues":
            candidate = LocalQueueCandidates(
                window_size=window_size,
                max_tracks=max_tracks,
                min_new_track_points=min_new_track_points,
            )
        else:
            candidate = FixedWindowCandidates(
                window_size=window_size, min_new_track_points=min_new_track_points
            )
        kwargs = dict(
            candidate=candidate,
            min_match_points=min_match_points,
            features=features,
            scoring_method=scoring_method,
            scoring_reduction=scoring_reduction,
            track_matching_method=track_matching_method,
            robust_best_instance=robust_best_instance,
            oks_stddev=oks_stddev,
            tracking_target_instance_count=tracking_target_instance_count,
            tracking_pre_cull_to_target=tracking_pre_cull_to_target,
            tracking_pre_cull_iou_threshold=tracking_pre_cull_iou_threshold,
        )
        if use_kalman:
            return KalmanShiftTracker(
                **kwargs,
                kf_track_features=kf_track_features,
                kf_init_frame_count=kf_init_frame_count,
                kf_node_indices=kf_node_indices,
                kf_reset_gap_size=kf_reset_gap_size,
                kf_prediction_blend=kf_prediction_blend,
                kf_gate_step_mult=kf_gate_step_mult,
                kf_min_gate_px=kf_min_gate_px,
                kf_velocity_cap_mult=kf_velocity_cap_mult,
                kf_min_velocity_cap_px=kf_min_velocity_cap_px,
                **flow_kwargs,
            )
        if use_flow:
            return FlowShiftTracker(
                **kwargs,
                of_img_scale=of_img_scale,
                of_window_size=of_window_size,
                of_max_levels=of_max_levels,
                **flow_kwargs,
            )
        return cls(**kwargs)

    # -- core --------------------------------------------------------------------
    def _score_fn(self):
        fns = {
            "oks": functools.partial(compute_oks_score, stddev=self.oks_stddev),
            "iou": compute_iou,
            "cosine_sim": compute_cosine_sim,
            "euclidean_dist": compute_euclidean_distance,
            "mask_iou": compute_mask_iou,
        }
        if self.scoring_method not in fns:
            raise ValueError(
                f"Invalid scoring_method {self.scoring_method}; one of {sorted(fns)}"
            )
        return fns[self.scoring_method]

    def _reduce_fn(self):
        if self.scoring_reduction == "mean":
            return np.nanmean
        if self.scoring_reduction == "max":
            return np.nanmax
        if self.scoring_reduction == "robust_quantile":
            return functools.partial(np.nanquantile, q=self.robust_best_instance)
        raise ValueError(
            f"Invalid scoring_reduction {self.scoring_reduction}; "
            "one of mean, max, robust_quantile"
        )

    def get_features(self, instances, frame_idx, image=None):
        if self.features not in self._feature_methods:
            raise ValueError(
                f"Invalid features {self.features}; one of {sorted(self._feature_methods)}"
            )
        fm = self._feature_methods[self.features]
        return self.candidate.make_instances(
            [fm(i) for i in instances], instances, frame_idx, image
        )

    def update_candidates(self, image=None) -> Dict[int, List[TrackedInstanceFeature]]:
        return {
            tid: self.candidate.get_features_from_track_id(tid)
            for tid in self.candidate.current_tracks
        }

    def get_scores(self, current_instances, candidates_feature_dict) -> np.ndarray:
        score = self._score_fn()
        reduce = self._reduce_fn()
        tracks = self.candidate.current_tracks
        scores = np.zeros((len(current_instances), len(tracks)))
        for f_idx, ti in enumerate(current_instances):
            for t_idx, tid in enumerate(tracks):
                vals = [
                    score(ti.feature, c.shifted_keypoints if c.shifted_keypoints is not None else c.feature)
                    for c in candidates_feature_dict[tid]
                    if count_valid_points(c.src_predicted_instance) > self.min_match_points
                ]
                scores[f_idx, t_idx] = np.nan if not vals else reduce(vals)
        return scores

    def scores_to_cost_matrix(self, scores: np.ndarray) -> np.ndarray:
        cost = -scores
        cost[np.isnan(cost)] = np.inf
        return cost

    def assign_tracks(self, current_instances, cost_matrix):
        matcher = self._matching_methods.get(self.track_matching_method)
        if matcher is None:
            raise ValueError(
                f"Invalid track_matching_method {self.track_matching_method}"
            )
        rows, cols = matcher(cost_matrix)
        tracking_scores = [-cost_matrix[r, c] for r, c in zip(rows, cols)]
        return self.candidate.update_tracks(current_instances, rows, cols, tracking_scores)

    def track(
        self,
        untracked_instances: List[PredictedInstance],
        frame_idx: int,
        image: Optional[np.ndarray] = None,
    ) -> List[PredictedInstance]:
        """Assign track IDs to one frame's instances."""
        if (
            self.tracking_target_instance_count
            and self.tracking_pre_cull_to_target
            and self.features != "masks"  # the cull's boxes come from keypoints
        ):
            untracked_instances = cull_frame_instances(
                untracked_instances,
                self.tracking_target_instance_count,
                self.tracking_pre_cull_iou_threshold,
            )
        current = self.get_features(untracked_instances, frame_idx, image)
        if self.candidate.current_tracks:
            feats = self.update_candidates(image)
            scores = self.get_scores(current, feats)
            tracked = self.assign_tracks(current, self.scores_to_cost_matrix(scores))
        else:
            tracked = self.candidate.add_new_tracks(current)

        out = []
        for ti in tracked:
            if ti.track_id is not None:
                if ti.track_id not in self._track_objects:
                    self._track_objects[ti.track_id] = Track(f"track_{ti.track_id}")
                ti.src_instance.track = self._track_objects[ti.track_id]
                ti.src_instance.tracking_score = float(ti.tracking_score)
            out.append(ti.src_instance)
        return out

    def track_labels(self, labels: Labels, get_image: bool = False) -> Labels:
        """Track all frames of a Labels (sorted by video, frame_idx)."""
        lfs = sorted(
            labels.labeled_frames,
            key=lambda lf: (
                labels.videos.index(lf.video) if lf.video in labels.videos else 0,
                lf.frame_idx,
            ),
        )
        needs_img = get_image or isinstance(self, FlowShiftTracker)
        for lf in lfs:
            img = lf.image if (needs_img and lf.video is not None) else None
            if self.features == "masks":
                # Segmentation output: the masks carry the tracks. Every
                # frame is tracked, as below.
                self.track([m for m in lf.masks if m.area > 0], lf.frame_idx, img)
                continue
            # User-labeled instances take precedence for tracking; untracked
            # predictions are carried alongside.
            items = lf.user_instances if lf.has_user_instances else lf.predicted_instances
            # Track EVERY frame, including empty ones: the fixed candidate
            # window is FRAME-based, so an occlusion gap longer than the
            # window flushes candidates and re-entry starts a NEW track
            # rather than silently bridging arbitrary gaps.
            self.track(items, lf.frame_idx, img)
        labels.tracks = list(self._track_objects.values())
        return labels


class FlowShiftTracker(Tracker):
    """Shift candidates forward via Lucas-Kanade optical flow."""

    def __init__(self, *args, of_img_scale: float = 1.0, of_window_size: int = 21,
                 of_max_levels: int = 3, **kwargs):
        super().__init__(*args, **kwargs)
        self.of_img_scale = float(of_img_scale)
        self.of_window_size = of_window_size
        self.of_max_levels = of_max_levels

    def _compute_optical_flow(self, ref_pts: np.ndarray, ref_img: np.ndarray, new_img: np.ndarray):
        import cv2

        def gray(img):
            img = np.asarray(img)
            if img.ndim == 3 and img.shape[-1] == 3:
                return cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
            return img[..., 0] if img.ndim == 3 else img

        # of_img_scale < 1 downscales both frames before LK (cheaper flow on
        # large frames). Points map into the scaled
        # grid and the shifted results map back.
        s = self.of_img_scale if self.of_img_scale > 0 else 1.0
        ga, gb = gray(ref_img), gray(new_img)
        if s != 1.0:
            ga = cv2.resize(ga, None, fx=s, fy=s, interpolation=cv2.INTER_AREA)
            gb = cv2.resize(gb, None, fx=s, fy=s, interpolation=cv2.INTER_AREA)

        pts = ref_pts.reshape(-1, 1, 2).astype(np.float32)
        valid = ~np.isnan(pts[:, 0, :]).any(axis=-1)
        pts_in = np.nan_to_num(pts) * s
        shifted, status, _ = cv2.calcOpticalFlowPyrLK(
            ga,
            gb,
            pts_in,
            None,
            winSize=(self.of_window_size, self.of_window_size),
            maxLevel=self.of_max_levels,
        )
        shifted = (shifted / s).reshape(ref_pts.shape)
        ok = (status.reshape(-1) == 1) & valid
        shifted[~ok.reshape(ref_pts.shape[:-1])] = np.nan if ref_pts.ndim == 2 else np.nan
        return shifted

    def update_candidates(self, image=None):
        feats = super().update_candidates(image)
        if image is None:
            return feats
        for tid, cand_list in feats.items():
            for c in cand_list:
                ref_img = None
                # find the stored image of the candidate's frame
                for frame in (
                    self.candidate.tracker_queue
                    if not self.is_local_queue
                    else self.candidate.tracker_queue.get(tid, [])
                ):
                    items = frame if isinstance(frame, list) else [frame]
                    for ti in items:
                        if ti.frame_idx == c.frame_idx and ti.image is not None:
                            ref_img = ti.image
                            break
                    if ref_img is not None:
                        break
                if ref_img is None:
                    continue
                pts = np.asarray(c.feature, dtype=np.float32)
                if pts.ndim == 1:
                    pts = pts.reshape(1, -1)
                c.shifted_keypoints = self._compute_optical_flow(pts, ref_img, image)
        return feats

    def get_features(self, instances, frame_idx, image=None):
        return super().get_features(instances, frame_idx, image)

class KalmanShiftTracker(Tracker):
    """Per-track EM-fit constant-velocity Kalman prediction.

    Two phases:

    1. **Warm-up** — for the first ``kf_init_frame_count`` frames the tracker
       behaves exactly like the base path while a per-track observation
       history accumulates (kept outside the bounded candidate queue so the
       warm-up can span more frames than the queue holds).
    2. **Motion model** — one constant-velocity filter per track is EM-fit
       over a contiguous fresh window (``kalman.KalmanFilter.em`` learns only
       the noise covariances; structural matrices and the seeded initial mean
       stay fixed). Each frame thereafter: stale tracks are reset, matched
       filters are corrected with distance-GATED observations, coasting one
       masked step per missed frame so gap motion is not dumped into
       velocity, filters are lazily (re)fit for entrants/post-reset tracks,
       and the candidate is built by rigidly translating the last observed
       pose by ``kf_prediction_blend`` x the predicted centroid displacement.

    ``kf_track_features="centroid"`` tracks the single visibility-aware
    centroid (state ``[x, vx, y, vy]``); ``"keypoints"`` gives each selected
    node its own constant-velocity block (noisier; pair with a tolerant
    ``oks_stddev``).
    """

    def __init__(self, *args,
                 kf_track_features: str = "centroid",
                 kf_init_frame_count: int = 10,
                 kf_node_indices: Optional[List[int]] = None,
                 kf_reset_gap_size: int = 5,
                 kf_prediction_blend: float = 0.5,
                 kf_gate_step_mult: float = 8.0,
                 kf_min_gate_px: float = 40.0,
                 kf_velocity_cap_mult: float = 3.0,
                 kf_min_velocity_cap_px: float = 15.0,
                 max_velocity: Optional[float] = None,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.kf_track_features = kf_track_features
        self.kf_init_frame_count = int(kf_init_frame_count)
        self.kf_node_indices = (
            list(kf_node_indices) if kf_node_indices is not None else None
        )
        self.kf_reset_gap_size = int(kf_reset_gap_size)
        self.kf_prediction_blend = float(kf_prediction_blend)
        self.kf_gate_step_mult = float(kf_gate_step_mult)
        self.kf_min_gate_px = float(kf_min_gate_px)
        self.kf_velocity_cap_mult = float(kf_velocity_cap_mult)
        # Legacy `max_velocity` knob maps onto the velocity-cap floor (the
        # cap is what actually bounds the learned per-frame step now).
        self.kf_min_velocity_cap_px = (
            float(max_velocity) if max_velocity is not None
            else float(kf_min_velocity_cap_px)
        )
        self._filters: Dict[int, KalmanFilter] = {}
        self._last_results: Dict[int, Dict[str, np.ndarray]] = {}
        self._last_frame_for_track: Dict[int, int] = {}
        self._last_corrected_frame: Dict[int, int] = {}
        self._obs_history: Dict[int, List[dict]] = {}
        self._median_step: Dict[int, float] = {}
        self._reset_frame: Dict[int, int] = {}
        self._resolved_node_indices: Optional[List[int]] = None
        self._n_nodes: Optional[int] = None
        self._frames_seen: int = 0
        self._initialized: bool = False
        self._current_frame_idx: int = 0

    # -- frame loop --------------------------------------------------------------

    def track(self, untracked_instances, frame_idx, image=None):
        """Record the frame index, run base tracking, then ingest assignments.

        Observations enter `_obs_history` AFTER `super().track()` so each
        track id pairs with the instance actually matched this frame
       .
        """
        self._current_frame_idx = int(frame_idx)
        out = super().track(untracked_instances, frame_idx, image)
        self._ingest_observations()
        return out

    def update_candidates(self, image=None):
        if not self._initialized:
            self._frames_seen += 1
            if self._frames_seen >= self.kf_init_frame_count:
                self._init_filters()
            if not self._initialized:
                return super().update_candidates(image)
        # Reset BEFORE correcting so a track fed only gated-out observations
        # drops to the base path instead of being corrupted by a stale
        # extrapolation.
        self._reset_stale_tracks(self._current_frame_idx)
        self._correct_filters()
        self._init_missing_filters()
        return self._predict_candidates()

    def _ingest_observations(self):
        """Append each current track's newest matched observation to history."""
        for tid in self.candidate.current_tracks:
            feats = self.candidate.get_features_from_track_id(tid)
            if not feats:
                continue
            newest = max(
                feats,
                key=lambda tf: tf.frame_idx if tf.frame_idx is not None else -1,
            )
            fidx = (
                int(newest.frame_idx) if newest.frame_idx is not None
                else self._current_frame_idx
            )
            history = self._obs_history.setdefault(tid, [])
            if history and history[-1]["frame_idx"] >= fidx:
                continue
            kpts = np.asarray(get_keypoints(newest.src_predicted_instance),
                              dtype=float)
            history.append({
                "frame_idx": fidx,
                "keypoints": kpts,
                "src": newest.src_predicted_instance,
                "score": newest.tracking_score,
            })
            if self._n_nodes is None:
                self._n_nodes = kpts.shape[0]

    # -- geometry helpers ----------------------------------------------------------

    def _resolve_node_indices(self) -> List[int]:
        if self.kf_node_indices is not None:
            return [i for i in self.kf_node_indices if i < (self._n_nodes or 0)]
        return list(range(self._n_nodes)) if self._n_nodes else []

    def _num_track_points(self) -> int:
        if self.kf_track_features == "keypoints":
            return max(1, len(self._resolved_node_indices or []))
        return 1

    def _centroid(self, keypoints: np.ndarray) -> np.ndarray:
        """Visibility-aware centroid; NaN when under half the nodes are seen.

        A centroid from a small, shifting node subset is biased (it moves as
        different nodes drop out), so it is treated as a MISSING observation
        rather than a corrupting one.
        """
        pts = np.asarray(keypoints, dtype=float)[self._resolved_node_indices, :]
        visible = int((~np.isnan(pts).any(axis=1)).sum())
        if visible == 0 or visible * 2 < pts.shape[0]:
            return np.array([np.nan, np.nan])
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            return np.nanmean(pts, axis=0)

    def _tracked_points(self, keypoints: np.ndarray) -> np.ndarray:
        if self.kf_track_features == "keypoints":
            return np.asarray(keypoints, dtype=float)[
                self._resolved_node_indices, :
            ]
        return self._centroid(keypoints).reshape(1, 2)

    def _obs_vector(self, keypoints: np.ndarray) -> np.ndarray:
        return np.ma.masked_invalid(
            np.asarray(self._tracked_points(keypoints).flatten(), dtype=float)
        )

    @staticmethod
    def _predicted_points(mean: np.ndarray) -> np.ndarray:
        """State mean ``[x0,vx0,y0,vy0,...]`` -> positions ``[[x0,y0],...]``."""
        return np.asarray(mean)[::2].reshape(-1, 2)

    def _predicted_centroid(self, mean: np.ndarray) -> np.ndarray:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", category=RuntimeWarning)
            return np.nanmean(self._predicted_points(mean), axis=0)

    @staticmethod
    def _cap_velocity(mean: np.ndarray, cap: float) -> np.ndarray:
        mean = np.asarray(mean, dtype=float).copy()
        mean[1::2] = np.clip(mean[1::2], -cap, cap)
        return mean

    def _window_median_step(self, window: List[dict]) -> float:
        """Per-frame centroid step from endpoint displacement / elapsed FRAMES.

        Dividing by elapsed frames (not valid-interval count) keeps the
        estimate physical when centroids drop out mid-window — otherwise the
        gate/cap loosen exactly in the noisy regime they protect
       .
        """
        valid = [
            (h["frame_idx"], self._centroid(h["keypoints"]))
            for h in window
            if not np.isnan(self._centroid(h["keypoints"])).any()
        ]
        if len(valid) < 2:
            return 0.0
        span = valid[-1][0] - valid[0][0]
        if span <= 0:
            return 0.0
        return float(np.linalg.norm(valid[-1][1] - valid[0][1])) / span

    def _velocity_cap(self, tid: int) -> float:
        return max(self.kf_min_velocity_cap_px,
                   self.kf_velocity_cap_mult * self._median_step.get(tid, 0.0))

    def _gate_distance(self, tid: int) -> float:
        return max(self.kf_min_gate_px,
                   self.kf_gate_step_mult * self._median_step.get(tid, 0.0))

    def _contiguous_fresh_window(self, tid: int) -> List[dict]:
        """Longest contiguous post-reset suffix of a track's history.

        Fit windows never straddle an occlusion gap or a reset
       .
        """
        reset_frame = self._reset_frame.get(tid, -1)
        fresh = [h for h in self._obs_history.get(tid, [])
                 if h["frame_idx"] > reset_frame]
        if not fresh:
            return []
        window = [fresh[-1]]
        for h in reversed(fresh[:-1]):
            if window[0]["frame_idx"] - h["frame_idx"] == 1:
                window.insert(0, h)
            else:
                break
        return window

    # -- filter lifecycle ----------------------------------------------------------

    @staticmethod
    def _cv_matrices(n_points: int):
        """Block constant-velocity transition/observation matrices.

        State ``[x0, vx0, y0, vy0, ...]`` (4P); observation ``[x0, y0, ...]``
        (2P).
        """
        state_dim, obs_dim = 4 * n_points, 2 * n_points
        A = np.zeros((state_dim, state_dim))
        C = np.zeros((obs_dim, state_dim))
        for p in range(n_points):
            b = 4 * p
            A[b, b] = A[b, b + 1] = A[b + 1, b + 1] = 1.0
            A[b + 2, b + 2] = A[b + 2, b + 3] = A[b + 3, b + 3] = 1.0
            C[2 * p, b] = 1.0
            C[2 * p + 1, b + 2] = 1.0
        return A, C

    def _fit_track_filter(self, tid: int) -> bool:
        """EM-fit a filter over a contiguous fresh window.

        Seeds position from the first finite coordinate and a capped
        finite-difference velocity, keeps the seeded mean fixed during EM
        (only the three covariances are learned), and caps the fitted
        velocity so a short noisy window cannot run away.
        """
        window = self._contiguous_fresh_window(tid)
        if len(window) < 3:
            return False
        window = window[-self.kf_init_frame_count:]
        n_points = self._num_track_points()
        obs_dim = 2 * n_points
        rows = np.asarray(
            [self._tracked_points(h["keypoints"]).flatten() for h in window],
            dtype=float,
        )
        if int(np.sum(~np.isnan(rows).all(axis=1))) < 2:
            return False

        median_step = self._window_median_step(window)
        cap = max(self.kf_min_velocity_cap_px,
                  self.kf_velocity_cap_mult * median_step)

        first = np.full(obs_dim, np.nan)
        seed_vel = np.zeros(obs_dim)
        for c in range(obs_dim):
            finite_t = np.where(~np.isnan(rows[:, c]))[0]
            if len(finite_t) == 0:
                continue
            first[c] = rows[finite_t[0], c]
            for t in finite_t:
                if t + 1 < len(rows) and not np.isnan(rows[t + 1, c]):
                    seed_vel[c] = float(np.clip(rows[t + 1, c] - rows[t, c],
                                                -cap, cap))
                    break
        if np.isnan(first).all():
            return False
        if np.isnan(first).any():
            # Coordinates never seen in the window: fill with the same-axis
            # mean (never the image origin).
            for axis in (0, 1):
                vals = first[axis::2]
                fill = np.nanmean(vals) if not np.isnan(vals).all() else 0.0
                first[axis::2] = np.where(np.isnan(vals), fill, vals)

        init_mean = np.zeros(4 * n_points)
        init_mean[0::2] = first            # positions (x0, y0, x1, y1, ...)
        init_mean[1::2] = seed_vel         # matching velocities

        A, C = self._cv_matrices(n_points)
        try:
            kf = KalmanFilter(
                transition_matrices=A,
                observation_matrices=C,
                initial_state_mean=init_mean,
            ).em(
                np.ma.masked_invalid(rows),
                n_iter=20,
                em_vars=["transition_covariance", "observation_covariance",
                         "initial_state_covariance"],
            )
            means, covariances = kf.filter(np.ma.masked_invalid(rows))
        except Exception:
            return False

        self._filters[tid] = kf
        self._last_results[tid] = {
            "means": self._cap_velocity(means[-1], cap),
            "covariances": covariances[-1],
        }
        self._last_corrected_frame[tid] = window[-1]["frame_idx"]
        self._last_frame_for_track[tid] = window[-1]["frame_idx"]
        self._median_step[tid] = median_step
        return True

    def _init_filters(self):
        self._resolved_node_indices = self._resolve_node_indices()
        if not self._resolved_node_indices:
            self._initialized = True  # nothing to model; stay on base path
            return
        for tid in list(self._obs_history.keys()):
            self._fit_track_filter(tid)
        self._initialized = True

    def _init_missing_filters(self):
        """Lazily (re)fit entrants / post-reset tracks.

        Requires `kf_init_frame_count` CONTIGUOUS fresh observations so a
        just-reset track is not immediately re-fit across its own gap.
        """
        if not self._resolved_node_indices:
            return
        for tid in self.candidate.current_tracks:
            if tid in self._filters:
                continue
            if len(self._contiguous_fresh_window(tid)) >= self.kf_init_frame_count:
                self._fit_track_filter(tid)

    def _correct_filters(self):
        """Advance matched filters with gated observations.

        Coasts one masked step per missed frame before applying a
        reappearance observation; observations farther than the gate from
        the prediction are rejected as misses.
        """
        for tid, kf in list(self._filters.items()):
            history = self._obs_history.get(tid, [])
            last_corrected = self._last_corrected_frame.get(tid, -1)
            new_obs = [h for h in history if h["frame_idx"] > last_corrected]
            cap = self._velocity_cap(tid)
            gate = self._gate_distance(tid)
            for h in new_obs:
                prior = self._last_results[tid]
                mean, cov = prior["means"], prior["covariances"]
                gap = h["frame_idx"] - self._last_corrected_frame.get(tid, -1)
                try:
                    for _ in range(max(0, gap - 1)):
                        mean, cov = kf.filter_update(mean, cov,
                                                     observation=np.ma.masked)
                        mean = self._cap_velocity(mean, cap)
                    pred_mean, pred_cov = kf.filter_update(
                        mean, cov, observation=np.ma.masked
                    )
                    pred_c = self._predicted_centroid(pred_mean)
                    obs_c = self._centroid(h["keypoints"])
                    gated_out = (
                        not np.isnan(pred_c).any()
                        and not np.isnan(obs_c).any()
                        and float(np.linalg.norm(pred_c - obs_c)) > gate
                    )
                    if gated_out:
                        mean, cov = pred_mean, pred_cov
                    else:
                        mean, cov = kf.filter_update(
                            mean, cov, observation=self._obs_vector(h["keypoints"])
                        )
                except Exception:
                    break
                self._last_results[tid] = {
                    "means": self._cap_velocity(mean, cap),
                    "covariances": cov,
                }
                self._last_corrected_frame[tid] = h["frame_idx"]
                if not gated_out:
                    self._last_frame_for_track[tid] = h["frame_idx"]

    def _reset_stale_tracks(self, frame_idx: int):
        """Drop filters unseen past `kf_reset_gap_size`.

        The reset frame is stamped so the next fit window starts strictly
        after the occlusion gap.
        """
        stale = [tid for tid, last in self._last_frame_for_track.items()
                 if frame_idx - last > self.kf_reset_gap_size]
        for tid in stale:
            self._filters.pop(tid, None)
            self._last_results.pop(tid, None)
            self._last_frame_for_track.pop(tid, None)
            self._last_corrected_frame.pop(tid, None)
            self._median_step.pop(tid, None)
            self._reset_frame[tid] = frame_idx

    # -- candidate prediction --------------------------------------------------------

    def _predict_candidates(self) -> Dict[int, List[TrackedInstanceFeature]]:
        """Rigidly translate the last pose by the blended prediction
       .

        Translating the REAL last body keeps the candidate geometrically
        valid so similarity scores stay meaningful. Tracks without a live
        filter fall back to the base feature path.
        """
        fm = self._feature_methods[self.features]
        predicted: Dict[int, List[TrackedInstanceFeature]] = defaultdict(list)
        for tid in self.candidate.current_tracks:
            kf = self._filters.get(tid)
            prior = self._last_results.get(tid)
            history = self._obs_history.get(tid)
            if kf is None or prior is None or not history:
                predicted[tid].extend(self.candidate.get_features_from_track_id(tid))
                continue
            steps = max(
                1,
                self._current_frame_idx
                - self._last_corrected_frame.get(tid, self._current_frame_idx - 1),
            )
            cap = self._velocity_cap(tid)
            mean, cov = prior["means"], prior["covariances"]
            try:
                for _ in range(steps):
                    mean, cov = kf.filter_update(mean, cov,
                                                 observation=np.ma.masked)
                    mean = self._cap_velocity(mean, cap)
            except Exception:
                predicted[tid].extend(self.candidate.get_features_from_track_id(tid))
                continue

            ref = history[-1]
            last_kpts = np.asarray(ref["keypoints"], dtype=float)
            blend = self.kf_prediction_blend
            pred_c = self._predicted_centroid(mean)
            last_c = self._centroid(last_kpts)

            if np.isnan(pred_c).any() or np.isnan(last_c).any():
                cand = last_kpts  # no valid prediction: hold the last pose
            elif self.kf_track_features == "keypoints":
                # Per-node blend; non-tracked nodes translate rigidly by the
                # mean tracked displacement.
                idx = self._resolved_node_indices
                pred_pts = self._predicted_points(mean)
                last_tracked = last_kpts[idx]
                disp = pred_pts - last_tracked
                blended = last_tracked + blend * disp
                blended = np.where(np.isnan(blended), pred_pts, blended)
                cand = last_kpts.copy()
                cand[idx] = blended
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore", category=RuntimeWarning)
                    mean_disp = np.nanmean(disp, axis=0)
                if not np.isnan(mean_disp).any():
                    mask = np.ones(self._n_nodes, dtype=bool)
                    mask[idx] = False
                    cand[mask] = last_kpts[mask] + blend * mean_disp
            else:
                # Constant blend weight — a coasting prediction is LESS
                # reliable, so it is not amplified during gaps.
                cand = last_kpts + blend * (pred_c - last_c)

            feat = fm(cand)
            predicted[tid].append(TrackedInstanceFeature(
                feature=feat,
                src_predicted_instance=ref["src"],
                frame_idx=ref["frame_idx"],
                tracking_score=(ref["score"] if ref["score"] is not None else 1.0),
                # The repo's get_scores prefers shifted_keypoints; keep it
                # feature-shaped so every `features` mode scores the
                # prediction (pose for "keypoints", centroid for
                # "centroids", ...).
                shifted_keypoints=feat,
            ))
        return predicted


def connect_single_breaks(labels: Labels, max_instances: int) -> Labels:
    """Merge single-frame track breaks.

    Walks frames in order keeping the last "good" track set. When exactly one
    track disappears and exactly one new track appears on the same frame, the
    new track is an identity continuation of the lost one: the instance is
    remapped and the old->new mapping is remembered so later frames that
    still carry the spurious new track are fixed too.
    """
    lfs = sorted(labels.labeled_frames, key=lambda lf: lf.frame_idx)
    if not lfs:
        return labels

    fix_track_map: Dict[int, Track] = {}  # id(spurious track) -> original
    last_good = {inst.track for inst in lfs[0].instances if inst.track is not None}
    for lf in lfs:
        frame_tracks = {i.track for i in lf.instances if i.track is not None}

        # Apply previously-discovered fixes first (only when the fix target
        # isn't already present on this frame — no duplicate identities).
        for inst in lf.instances:
            fixed = fix_track_map.get(id(inst.track))
            if fixed is not None and fixed not in frame_tracks:
                inst.track = fixed
                frame_tracks = {i.track for i in lf.instances if i.track is not None}

        extra = frame_tracks - last_good
        missing = last_good - frame_tracks
        if len(extra) == 1 and len(missing) == 1:
            for inst in lf.instances:
                if inst.track in extra:
                    old, new = inst.track, missing.pop()
                    fix_track_map[id(old)] = new
                    inst.track = new
                    break
        elif len(frame_tracks) >= len(last_good):
            # Only refresh the reference set when the frame is at least as
            # populated — prevents a dropout frame from becoming the baseline.
            last_good = frame_tracks
    return labels


def run_tracker(
    labels: Labels,
    post_connect_single_breaks: bool = False,
    target_instance_count: Optional[int] = None,
    pre_cull_to_target: bool = False,
    pre_cull_iou_threshold: float = 0,
    clean_instance_count: int = 0,
    clean_iou_threshold: float = 0,
    **config,
) -> Labels:
    """Track a Labels end-to-end from config knobs.

    ``pre_cull_to_target`` culls every frame to ``target_instance_count``
    before tracking (bbox-NMS + score); ``clean_instance_count`` culls every
    frame to that count *after* tracking; ``post_connect_single_breaks`` merges
    single-frame identity breaks last.
    """
    # Fail fast BEFORE tracking: both the pre-cull and the single-break repair require
    # an explicit target identity count; silently no-op'ing the cull or raising
    # only after a long tracking pass were the legacy bugs.
    if (post_connect_single_breaks or pre_cull_to_target) and not target_instance_count:
        raise ValueError(
            "post_connect_single_breaks and pre_cull_to_target require "
            "target_instance_count to be set (the CLI derives it from "
            "--max_instances when omitted)."
        )
    if pre_cull_to_target and target_instance_count:
        cull_instances(labels, target_instance_count, pre_cull_iou_threshold)
    # The target identity count also informs the tracker itself (per-frame
    # cull inside tracking, Kalman init) — forward it unless the caller set
    # the tracker-level knob explicitly.
    if target_instance_count and "tracking_target_instance_count" not in config:
        config["tracking_target_instance_count"] = target_instance_count
    tracker = Tracker.from_config(**config)
    labels = tracker.track_labels(labels)
    if clean_instance_count:
        cull_instances(labels, clean_instance_count, clean_iou_threshold)
    if post_connect_single_breaks:
        labels = connect_single_breaks(labels, target_instance_count)
    return labels
