"""Port parity: the ``tracking`` package (``utils``, ``candidates``,
``kalman``, ``tracker``) against the JAX package.

The cases mirror ``tests/tracking/*.py``: synthetic animals that move in
straight lines, cross, drop out for a few frames or for longer than the
candidate window, enter late, carry jittered and missing nodes, and
near-duplicate detections, made from a numpy seed. Each scene is built as
``Labels`` of ``PredictedInstance``s in both packages and tracked with the
same knobs, over fixed-window and local-queue candidates, keypoint,
centroid and bounding-box features, OKS, IoU, cosine and euclidean scores,
Hungarian and greedy matching, the Kalman tracker (centroid and keypoint
models) and the flow-shift tracker (cv2), and ``run_tracker``'s pre-cull,
clean cull and ``connect_single_breaks``. Track assignments and the
instances kept must be exactly equal; tracking scores and the Kalman state
within 1e-9. The mask feature is held here in brief.
"""

import numpy as np
import pytest

from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.tracking import candidates as jcand
from sleap_nn_tpu.tracking import kalman as jkal
from sleap_nn_tpu.tracking import tracker as jtr
from sleap_nn_tpu.tracking import utils as jut
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.tracking import candidates as pcand
from sleap_nn_tpu_torch.tracking import kalman as pkal
from sleap_nn_tpu_torch.tracking import tracker as ptr
from sleap_nn_tpu_torch.tracking import utils as put
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

JAX = (jio, jtr)
PORT = (pio, ptr)
TOL = 1e-9
OFFSETS = np.array([[0.0, 0.0], [6.0, 0.0], [0.0, 6.0]])


class FrameVideo:
    """An in-memory video: ``video[i]`` is frame ``i``."""

    def __init__(self, frames):
        self.frames = frames

    def __getitem__(self, idx):
        return self.frames[idx]


# -- scenes: per frame, a list of (points (N, 2), score) ---------------------------


def pose(xy):
    return np.asarray(xy, float) + OFFSETS


def paths_scene(paths, drop=lambda k, t: False, n=None):
    n = n or max(len(p) for p in paths)
    return [[(pose(p[t]), 1.0) for k, p in enumerate(paths) if t < len(p) and not drop(k, t)]
            for t in range(n)]


def straight(start, velocity, n):
    return [np.asarray(start, float) + t * np.asarray(velocity, float) for t in range(n)]


def noisy_scene(seed=7, n=24):
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(n):
        insts = [(pose([30.0 + 3.0 * t, 50.0]) + rng.normal(0, 0.8, (3, 2)), 0.9),
                 (pose([90.0, 10.0 + 3.0 * t]) + rng.normal(0, 0.8, (3, 2)), 0.8)]
        if t in (8, 14, 20):
            insts.append((pose([400.0, 400.0]), 0.3))
        frames.append(insts)
    return frames


def random_walk_scene(seed, n=30, n_animals=4):
    """Animals on smooth random walks, 30+ px apart at the start, with NaN
    nodes, dropouts, random scores and a late entrant."""
    rng = np.random.default_rng(seed)
    pos = np.stack([np.array([40.0 + 70.0 * k, 60.0 + 25.0 * (k % 2)]) for k in range(n_animals)])
    vel = rng.normal(0, 1.5, (n_animals, 2))
    frames = []
    for t in range(n):
        vel += rng.normal(0, 0.3, vel.shape)
        pos += vel
        insts = []
        for k in range(n_animals):
            if (k == n_animals - 1 and t < 6) or rng.random() < 0.08:
                continue
            pts = pose(pos[k]) + rng.normal(0, 0.5, (3, 2))
            pts[rng.random(3) < 0.1] = np.nan
            insts.append((pts, float(rng.uniform(0.3, 1.0))))
        frames.append(insts)
    return frames


def duplicates_scene(n=6):
    return [[(pose([20 + 2 * t, 20]), 0.9), (pose([80, 80 + 2 * t]), 0.8),
             (pose([21 + 2 * t, 20]), 0.1), (pose([140, 30 + t]), 0.2)] for t in range(n)]


SCENES = {
    "two_linear": paths_scene([straight([20, 20], [2, 0], 10), straight([80, 80], [0, 2], 10)]),
    "crossing": paths_scene([straight([10, 40], [4, 0], 24), straight([100, 44], [-4, 0], 24)]),
    "short_gap": paths_scene([straight([20, 30], [3, 0], 26), straight([60, 90], [0, 2], 26)],
                             drop=lambda k, t: k == 1 and t in (12, 13)),
    "long_occlusion": paths_scene(
        [straight([15, 25], [2, 0], 30), straight([120, 20], [0, 3], 30)],
        drop=lambda k, t: k == 1 and 10 <= t < 19),
    "entering": paths_scene([straight([10, 10], [1.5, 0], 40), straight([10, 120], [1.5, 0], 40),
                             [None] * 10 + straight([200, 200], [-1, 0], 30)],
                            drop=lambda k, t: k == 2 and t < 10),
    "noisy_fp": noisy_scene(),
    "duplicates": duplicates_scene(),
    **{f"walk_{s}": random_walk_scene(s) for s in range(3)},
}


def make_labels(io, scene, video=None):
    skel = io.Skeleton(nodes=["a", "b", "c"])
    lfs = [io.LabeledFrame(video, t, [io.PredictedInstance(
        points=pts, skeleton=skel, point_scores=np.ones(3), score=score) for pts, score in insts])
        for t, insts in enumerate(scene)]
    return io.Labels(lfs, skeletons=[skel])


def tracked(labels):
    """Per frame: each instance's points, track name and tracking score; and
    the Labels' track names."""
    rows = []
    for lf in sorted(labels.labeled_frames, key=lambda f: f.frame_idx):
        rows.append([(i.points, i.track.name if i.track is not None else None,
                      getattr(i, "tracking_score", None)) for i in lf.instances])
    return rows, [t.name for t in labels.tracks]


def assert_tracks_equal(want, got):
    (wrows, wtracks), (grows, gtracks) = want, got
    assert gtracks == wtracks
    assert len(grows) == len(wrows)
    for t, (w, g) in enumerate(zip(wrows, grows)):
        assert [x[1] for x in g] == [x[1] for x in w], t
        for (wp, _, ws), (gp, _, gs) in zip(w, g):
            np.testing.assert_array_equal(gp, wp)
            assert abs(gs - ws) <= TOL, (t, gs, ws)


def run_both(scene, fn, video=None):
    """``fn(io, tracker_module, labels)`` in both packages; returns the
    tracked results (JAX, port)."""
    out = []
    for io, tr in (JAX, PORT):
        out.append(tracked(fn(io, tr, make_labels(io, scene, video))))
    return out


def with_config(**cfg):
    return lambda io, tr, labels: tr.Tracker.from_config(**cfg).track_labels(labels)


# -- the base tracker ----------------------------------------------------------------

FEATURE_SCORES = [(f, s) for f in ("keypoints", "centroids", "bboxes")
                  for s in ("oks", "iou", "cosine_sim", "euclidean_dist")
                  if not (s == "iou" and f != "bboxes") and not (f == "bboxes" and s == "oks")]


@pytest.mark.parametrize("scene", ["crossing", "walk_0", "entering"])
@pytest.mark.parametrize("matching", ["hungarian", "greedy"])
@pytest.mark.parametrize("features,scoring", FEATURE_SCORES)
def test_features_scores_and_matching_match_jax(scene, matching, features, scoring):
    cfg = dict(features=features, scoring_method=scoring, track_matching_method=matching)
    want, got = run_both(SCENES[scene], with_config(**cfg))
    assert_tracks_equal(want, got)
    assert len(got[1]) >= 2


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("candidates", [
    {"candidates_method": "fixed_window", "window_size": 5},
    {"candidates_method": "fixed_window", "window_size": 2},
    {"candidates_method": "local_queues", "window_size": 5},
    {"max_tracks": 2, "window_size": 3},
], ids=["fixed5", "fixed2", "local5", "max_tracks2"])
def test_candidates_match_jax(scene, candidates):
    want, got = run_both(SCENES[scene], with_config(**candidates))
    assert_tracks_equal(want, got)


@pytest.mark.parametrize("cfg", [
    {"scoring_reduction": "max"},
    {"scoring_reduction": "robust_quantile", "robust_best_instance": 0.8},
    {"min_match_points": 2},
    {"min_new_track_points": 3},
    {"oks_stddev": 0.1},
    {"tracking_target_instance_count": 2, "tracking_pre_cull_to_target": 1,
     "tracking_pre_cull_iou_threshold": 0.3},
], ids=["max", "robust_quantile", "min_match_points", "min_new_track_points", "oks_stddev",
        "pre_cull"])
@pytest.mark.parametrize("scene", ["walk_1", "noisy_fp", "duplicates"])
def test_tracker_knobs_match_jax(cfg, scene):
    want, got = run_both(SCENES[scene], with_config(window_size=4, **cfg))
    assert_tracks_equal(want, got)


# -- the Kalman tracker ----------------------------------------------------------------


def kalman_state(tracker):
    return {tid: (r["means"], r["covariances"]) for tid, r in tracker._last_results.items()}, {
        tid: (kf.transition_covariance, kf.observation_covariance, kf.initial_state_covariance)
        for tid, kf in tracker._filters.items()}


@pytest.mark.parametrize("scene", ["crossing", "short_gap", "long_occlusion", "noisy_fp",
                                   "walk_2"])
@pytest.mark.parametrize("mode", [
    {"kf_track_features": "centroid"},
    {"kf_track_features": "keypoints"},
    {"kf_track_features": "keypoints", "kf_node_indices": [0, 2]},
    {"kf_track_features": "centroid", "features": "centroids",
     "scoring_method": "euclidean_dist"},
], ids=["centroid", "keypoints", "node_indices", "centroid_euclidean"])
def test_kalman_tracker_matches_jax(scene, mode):
    states = []

    def run(io, tr, labels):
        tracker = tr.Tracker.from_config(window_size=5, use_kalman=True, kf_init_frame_count=5,
                                         kf_reset_gap_size=5,
                                         tracking_target_instance_count=2, **mode)
        out = tracker.track_labels(labels)
        assert isinstance(tracker, tr.KalmanShiftTracker) and tracker._initialized
        states.append(kalman_state(tracker))
        return out

    want, got = run_both(SCENES[scene], run)
    assert_tracks_equal(want, got)
    (wres, wfilt), (gres, gfilt) = states
    assert sorted(gres) == sorted(wres) and sorted(gfilt) == sorted(wfilt) and gfilt
    for tid in wres:
        for w, g in zip(wres[tid], gres[tid]):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    for tid in wfilt:
        for w, g in zip(wfilt[tid], gfilt[tid]):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def test_kalman_stale_reset_and_velocity_cap_match_jax():
    scene = paths_scene([straight([20, 40], [2, 0], 30), [np.array([150.0, 100.0])] * 30],
                        drop=lambda k, t: k == 1 and 10 <= t < 20)
    cfg = dict(use_kalman=True, tracking_target_instance_count=2, features="centroids",
               scoring_method="euclidean_dist", kf_init_frame_count=3, kf_reset_gap_size=4,
               window_size=15, max_velocity=4.0)
    want, got = run_both(scene, with_config(**cfg))
    assert_tracks_equal(want, got)


# -- the flow-shift tracker (cv2) ---------------------------------------------------------


def blob_video(seed=0, n=10):
    """Two bright blobs moving across noise: frames ``(n, 64, 96, 1)`` and the
    blobs' poses."""
    rng = np.random.default_rng(seed)
    frames = rng.normal(8, 2, (n, 64, 96, 1)).clip(0, 255).astype(np.uint8)
    scene = []
    for t in range(n):
        a, b = np.array([10.0 + 3 * t, 16.0]), np.array([80.0 - 3 * t, 44.0])
        for x, y in (a, b):
            frames[t, int(y) - 4:int(y) + 8, int(x) - 4:int(x) + 8] = 255
        scene.append([(pose(a) * [1, 1] + rng.normal(0, 0.3, (3, 2)), 0.9),
                      (pose(b) + rng.normal(0, 0.3, (3, 2)), 0.8)])
    return frames, scene


@pytest.mark.parametrize("cfg", [
    {}, {"of_img_scale": 0.5, "of_window_size": 15, "of_max_levels": 2},
    {"candidates_method": "local_queues", "features": "centroids",
     "scoring_method": "euclidean_dist"},
], ids=["default", "half_scale", "local_centroids"])
def test_flow_shift_tracker_matches_jax(cfg):
    pytest.importorskip("cv2")
    frames, scene = blob_video()
    want, got = run_both(scene, with_config(window_size=3, use_flow=True, **cfg),
                         video=FrameVideo(frames))
    assert_tracks_equal(want, got)
    rng = np.random.default_rng(3)
    base = (rng.random((96, 128)) * 255).astype(np.uint8)
    shifted = np.roll(base, shift=4, axis=1)
    pts = np.array([[40.0, 40.0], [60.0, 50.0], [np.nan, np.nan]], np.float32)
    flows = [tr.Tracker.from_config(use_flow=True, **cfg)._compute_optical_flow(pts, base, shifted)
             for tr in (jtr, ptr)]
    np.testing.assert_array_equal(flows[1], flows[0])


def test_flow_shift_tracker_needs_cv2(monkeypatch):
    import sys

    monkeypatch.setitem(sys.modules, "cv2", None)
    tracker = ptr.Tracker.from_config(use_flow=True)
    with pytest.raises(ImportError):
        tracker._compute_optical_flow(np.zeros((1, 2), np.float32),
                                      np.zeros((8, 8), np.uint8), np.zeros((8, 8), np.uint8))


# -- run_tracker, culls and single-break repair ------------------------------------------


@pytest.mark.parametrize("kw", [
    {"target_instance_count": 2, "pre_cull_to_target": True, "pre_cull_iou_threshold": 0.3},
    {"target_instance_count": 2, "pre_cull_to_target": True},
    {"clean_instance_count": 2},
    {"clean_instance_count": 2, "clean_iou_threshold": 0.3},
    {"target_instance_count": 2, "post_connect_single_breaks": True},
    {"target_instance_count": 2, "pre_cull_to_target": True, "pre_cull_iou_threshold": 0.3,
     "post_connect_single_breaks": True, "scoring_method": "oks"},
    {"target_instance_count": 2, "use_kalman": True, "kf_init_frame_count": 3},
], ids=["pre_cull_iou", "pre_cull", "clean", "clean_iou", "connect", "all", "kalman_target"])
@pytest.mark.parametrize("scene", ["duplicates", "noisy_fp", "short_gap", "walk_0"])
def test_run_tracker_matches_jax(kw, scene):
    want, got = run_both(SCENES[scene],
                         lambda io, tr, labels: tr.run_tracker(labels, window_size=3, **kw))
    assert_tracks_equal(want, got)


def test_connect_single_breaks_matches_jax():
    out = []
    for io, tr in (JAX, PORT):
        t1, t2, t3 = io.Track("track_0"), io.Track("track_1"), io.Track("track_2")
        labels = make_labels(io, SCENES["two_linear"][:6])
        for fi, lf in enumerate(labels.labeled_frames):
            lf.instances[0].track = t1
            lf.instances[1].track = t2 if fi < 3 else t3
        labels.labeled_frames[4].instances[1].track = t2  # the lost track comes back once
        tr.connect_single_breaks(labels, max_instances=2)
        out.append([[i.track.name for i in lf.instances] for lf in labels.labeled_frames])
    assert out[1] == out[0]
    assert all(set(row) == {"track_0", "track_1"} for row in out[1])


@pytest.mark.parametrize("kw", [
    {"post_connect_single_breaks": True}, {"pre_cull_to_target": True},
    {"use_kalman": True}, {"use_kalman": True, "use_flow": True, "max_tracks": 2},
    {"use_kalman": True, "kf_track_features": "nodes", "max_tracks": 2},
], ids=["connect", "pre_cull", "kalman_count", "kalman_flow", "kf_features"])
def test_config_errors_match_jax(kw):
    errs = []
    for io, tr in (JAX, PORT):
        with pytest.raises(ValueError) as err:
            tr.run_tracker(make_labels(io, SCENES["two_linear"]), **kw)
        errs.append(str(err.value))
    assert errs[1] == errs[0]


@pytest.mark.parametrize("kw", [
    {"features": "nodes"}, {"scoring_method": "l1"}, {"scoring_reduction": "median"},
    {"track_matching_method": "auction"},
], ids=["features", "scoring", "reduction", "matching"])
def test_invalid_knobs_raise_like_jax(kw):
    errs = []
    for io, tr in (JAX, PORT):
        with pytest.raises(ValueError) as err:
            tr.Tracker.from_config(**kw).track_labels(make_labels(io, SCENES["two_linear"]))
        errs.append(str(err.value))
    # The port lists the same valid names, the mask ones included.
    assert errs[1] == errs[0]


def test_empty_and_single_frames_match_jax():
    scene = [[], [(pose([10, 10]), 1.0)], [], [], [(pose([12, 10]), 1.0)], []]
    for cfg in ({}, {"use_kalman": True, "tracking_target_instance_count": 1}):
        want, got = run_both(scene, with_config(window_size=2, **cfg))
        assert_tracks_equal(want, got)


# -- utils ---------------------------------------------------------------------------


def test_matching_matches_jax():
    rng = np.random.default_rng(0)
    for shape in ((4, 4), (3, 5), (5, 2)):
        cost = rng.uniform(-1, 1, shape)
        cost[rng.random(shape) < 0.3] = np.inf
        for name in ("hungarian_matching", "greedy_matching"):
            w, g = getattr(jut, name)(cost), getattr(put, name)(cost)
            for a, b in zip(w, g):
                np.testing.assert_array_equal(b, a)
    inf = np.full((3, 3), np.inf)
    assert all(len(x) == 0 for x in put.hungarian_matching(inf) + put.greedy_matching(inf))


def test_features_and_scores_match_jax():
    rng = np.random.default_rng(1)
    for _ in range(10):
        a, b = rng.uniform(0, 50, (2, 4, 2))
        a[rng.random(4) < 0.2] = np.nan
        for f in ("get_keypoints", "get_centroid", "get_bbox"):
            np.testing.assert_array_equal(getattr(put, f)(a), getattr(jut, f)(a))
        assert put.count_valid_points(a) == jut.count_valid_points(a)
        assert put.compute_oks_score(a, b) == jut.compute_oks_score(a, b)
        assert put.compute_oks_score(a, b, 0.1) == jut.compute_oks_score(a, b, 0.1)
        assert put.compute_cosine_sim(a, b) == jut.compute_cosine_sim(a, b)
        assert put.compute_euclidean_distance(a, b) == jut.compute_euclidean_distance(a, b)
        ba, bb = jut.get_bbox(b), jut.get_bbox(b[::-1] + rng.uniform(-5, 5, (4, 2)))
        assert put.compute_iou(ba, bb) == jut.compute_iou(ba, bb)
    assert put.compute_iou([0, 0, 1, 1], [2, 2, 3, 3]) == 0.0
    assert put.compute_cosine_sim(np.zeros(4), np.ones(4)) == 0.0


def test_nms_and_culls_match_jax():
    rng = np.random.default_rng(2)
    boxes = np.concatenate([rng.uniform(0, 50, (12, 2)), np.zeros((12, 2))], axis=1)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 20, (12, 2))
    scores = rng.uniform(0, 1, 12)
    for thr in (0.1, 0.3, 0.7):
        for target in (None, 3):
            assert put.nms_fast(boxes, scores, thr, target) == jut.nms_fast(boxes, scores, thr,
                                                                             target)
    for count, thr in ((2, 0), (2, 0.3), (3, 0.3), (10, 0)):
        got = []
        for io, ut in ((jio, jut), (pio, put)):
            labels = make_labels(io, SCENES["duplicates"])
            kept = ut.cull_frame_instances(labels.labeled_frames[0].instances, count, thr)
            ut.cull_instances(labels, count, thr)
            got.append(([i.score for i in kept],
                        [[i.score for i in lf.instances] for lf in labels.labeled_frames]))
        assert got[1] == got[0]


# -- candidates --------------------------------------------------------------------------


@pytest.mark.parametrize("cls,kw", [
    ("FixedWindowCandidates", {"window_size": 3}),
    ("FixedWindowCandidates", {"window_size": 2, "min_new_track_points": 3}),
    ("LocalQueueCandidates", {"window_size": 2}),
    ("LocalQueueCandidates", {"window_size": 3, "max_tracks": 2}),
])
def test_candidate_stores_match_jax(cls, kw):
    scene = SCENES["walk_1"][:8]
    states = []
    for io, cand in ((jio, jcand), (pio, pcand)):
        store = getattr(cand, cls)(**kw)
        labels = make_labels(io, scene)
        for t, lf in enumerate(labels.labeled_frames):
            feats = [i.numpy() for i in lf.instances]
            tis = store.make_instances(feats, lf.instances, t)
            if not store.current_tracks:
                store.add_new_tracks(tis)
            else:
                n = min(len(tis), len(store.current_tracks))
                store.update_tracks(tis, list(range(n)), list(range(n))[::-1], [0.5] * n)
        states.append((store.current_tracks,
                       {tid: [(f.frame_idx, f.tracking_score) for f in
                              store.get_features_from_track_id(tid)]
                        for tid in store.current_tracks}))
    assert states[1] == states[0]


# -- the Kalman filter ---------------------------------------------------------------------


def _cv_model():
    a = np.array([[1, 1, 0, 0], [0, 1, 0, 0], [0, 0, 1, 1], [0, 0, 0, 1]], float)
    c = np.array([[1, 0, 0, 0], [0, 0, 1, 0]], float)
    return a, c


def _simulate(seed, t_len=40, missing=()):
    rng = np.random.default_rng(seed)
    a, c = _cv_model()
    x = np.array([10.0, 1.2, 40.0, -0.8])
    obs = []
    for _ in range(t_len):
        x = a @ x + rng.normal(0, 0.05, 4)
        obs.append(c @ x + rng.normal(0, 1.5, 2))
    obs = np.array(obs)
    obs[list(missing)] = np.nan
    return np.ma.masked_invalid(obs)


@pytest.mark.parametrize("seed,missing,em_vars", [
    (0, (), None),
    (1, (5, 6, 7, 20), ["transition_covariance", "observation_covariance",
                        "initial_state_covariance"]),
    (2, (0, 39), ["observation_covariance", "initial_state_mean"]),
])
def test_kalman_filter_matches_jax(seed, missing, em_vars):
    obs = _simulate(seed, missing=missing)
    a, c = _cv_model()
    kfs = [mod.KalmanFilter(transition_matrices=a, observation_matrices=c,
                            initial_state_mean=[obs[0, 0] if not missing else 0.0, 0, 0, 0])
           for mod in (jkal, pkal)]
    for kf in kfs:
        kf.em(obs, n_iter=8, em_vars=em_vars)
    for name in ("transition_covariance", "observation_covariance", "initial_state_covariance",
                 "initial_state_mean"):
        np.testing.assert_allclose(getattr(kfs[1], name), getattr(kfs[0], name), rtol=0, atol=TOL)
    for method in ("filter", "smooth"):
        for w, g in zip(getattr(kfs[0], method)(obs), getattr(kfs[1], method)(obs)):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    assert abs(kfs[1].loglikelihood(obs) - kfs[0].loglikelihood(obs)) <= TOL
    mean, cov = kfs[0].filter(obs)
    for z in (obs[3], np.ma.masked, np.array([1.0, np.nan])):
        for w, g in zip(kfs[0].filter_update(mean[-1], cov[-1], observation=z),
                        kfs[1].filter_update(mean[-1], cov[-1], observation=z)):
            np.testing.assert_allclose(g, w, rtol=0, atol=TOL)
    with pytest.raises(ValueError):
        pkal.KalmanFilter(transition_matrices=np.eye(3), observation_matrices=np.eye(2))
    with pytest.raises(ValueError):
        kfs[1].em(obs, em_vars=["transition_matrices"])


# -- the mask feature (tests/test_torch_segmentation_track.py holds it in full) ----------


def _disk(c, r=6, hw=160):
    yy, xx = np.mgrid[:hw, :hw]
    return (xx - c[0]) ** 2 + (yy - c[1]) ** 2 < r * r


def _mask_labels(io, scene):
    """The scene with each instance's pose replaced by a disk mask around it."""
    labels = make_labels(io, scene)
    for lf in labels.labeled_frames:
        lf.masks = [io.SegmentationMask(_disk(np.asarray(i.points)[0]), score=i.score)
                    for i in lf.instances]
        lf.instances = []
    return labels


def _mask_tracks(labels):
    return ([[m.track.name if m.track is not None else None for m in lf.masks]
             for lf in labels.labeled_frames], [t.name for t in labels.tracks])


@pytest.mark.parametrize("call", [
    lambda io, tr, ut: _mask_tracks(tr.Tracker.from_config(features="masks").track_labels(
        _mask_labels(io, SCENES["two_linear"]))),
    lambda io, tr, ut: _mask_tracks(tr.Tracker.from_config(
        features="masks", scoring_method="mask_iou").track_labels(
            _mask_labels(io, SCENES["two_linear"]))),
    lambda io, tr, ut: _mask_tracks(tr.run_tracker(
        _mask_labels(io, SCENES["crossing"]), features="masks", scoring_method="mask_iou")),
    lambda io, tr, ut: (lambda f: (f.crop.tolist(), f.y0, f.x0, f.area))(
        ut.MaskFeature(np.ones((2, 2), bool), 0, 0, 4).rescaled(0.5)),
    lambda io, tr, ut: (lambda f: (f.crop.tolist(), f.y0, f.x0, f.area, f.scale))(
        ut.get_mask(np.pad(np.ones((4, 3), bool), ((2, 1), (5, 0))))),
    lambda io, tr, ut: (ut.is_segmentation_mask(np.ones((4, 4), bool)),
                        ut.is_segmentation_mask(io.SegmentationMask(np.ones((4, 4), bool)))),
    lambda io, tr, ut: ut.compute_mask_iou(_disk((30, 30)), _disk((33, 31))),
], ids=["features", "scoring", "run_tracker", "MaskFeature", "get_mask",
        "is_segmentation_mask", "compute_mask_iou"])
def test_mask_tracking_raises_naming_item_10(call):
    # Mask tracking is ported: each call gives what the JAX package gives
    # (the masks feature under the default OKS score fails in both alike).
    def outcome(*mods):
        try:
            return call(*mods)
        except Exception as e:  # noqa: BLE001
            return type(e)

    assert outcome(pio, ptr, put) == outcome(jio, jtr, jut)
