"""Port parity: ``run.predict`` with tracking (``tracking=True``, a
``tracker`` object and the tracker knobs) against the JAX package's
``predict``, from the port's model dirs of ``tests/test_torch_model_dir.py``.

The clip: two blobs that move 1 px a frame on paths about 40 px apart,
so that no assignment is a near-tie. Both packages predict and track it
from the same dirs on the CPU: every instance's track is the same, and
keypoints agree to the model-dir tests' 1e-4 px (1e-5 bottom-up). A
typo'd tracker knob raises ``TypeError`` as in the JAX package; tracking
with centroid records or a streamed output raises ``ValueError`` alike.
"""

import numpy as np
import pytest

from sleap_nn_tpu.inference.run import predict as jax_predict
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.tracking import Tracker as JTracker
from sleap_nn_tpu_torch.inference import run as prun
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.tracking import Tracker as PTracker
from tests.test_torch_model_dir import (  # noqa: F401  (dirs is a fixture)
    HW,
    KW,
    FrameVideo,
    _paths,
    dirs,
    scipy_grouping,
)

N_FRAMES = 7


def moving_blob_frames(n=N_FRAMES):
    """Two Gaussian blobs (sigma 3): one at (16 + t, 16), one at (48 - t, 48)."""
    yy, xx = np.mgrid[:HW, :HW]
    out = np.zeros((n, HW, HW, 1), np.float32)
    for t in range(n):
        for cx, cy in ((16.0 + t, 16.0), (48.0 - t, 48.0)):
            out[t, ..., 0] += np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 3.0**2))
    return (np.clip(out, 0, 1) * 255).astype(np.uint8)


def source(io):
    video = FrameVideo(moving_blob_frames())
    return io.Labels([io.LabeledFrame(video, i) for i in range(N_FRAMES)])


def tracks_and_points(labels):
    rows = [[(i.track.name if i.track is not None else None, i.points) for i in lf.instances]
            for lf in labels.labeled_frames]
    return rows, [t.name for t in labels.tracks]


def assert_same_tracking(got, want, atol, all_tracked=True):
    (grows, gtracks), (wrows, wtracks) = tracks_and_points(got), tracks_and_points(want)
    assert gtracks == wtracks and len(grows) == len(wrows)
    for g, w in zip(grows, wrows):
        assert [t for t, _ in g] == [t for t, _ in w]
        for (_, gp), (_, wp) in zip(g, w):
            np.testing.assert_array_equal(np.isnan(gp), np.isnan(wp))
            np.testing.assert_allclose(gp, wp, rtol=0, atol=atol)
    if all_tracked:
        assert all(t is not None for row in grows for t, _ in row)


CASES = {
    "default": {},
    "centroids": {"features": "centroids", "scoring_method": "euclidean_dist"},
    "local_queues": {"candidates_method": "local_queues", "max_tracks": 2, "window_size": 3},
    "kalman": {"use_kalman": True, "tracking_target_instance_count": 2,
               "kf_init_frame_count": 3, "post_connect_single_breaks": True,
               "target_instance_count": 2},
}


@pytest.mark.parametrize("type_set,case", [
    (t, c) for t in ("single_instance", "topdown", "bottomup") for c in sorted(CASES)
    if not (t == "single_instance" and c == "kalman")])  # one animal: no Kalman count of 2
def test_tracked_predict_matches_jax(dirs, scipy_grouping, type_set, case):  # noqa: F811
    paths = _paths(dirs, type_set)
    kw = dict(batch_size=4, tracking=True, **KW[type_set], **CASES[case])
    got = prun.predict(source(pio), paths, device="cpu", **kw)
    want = jax_predict(source(jio), paths, **kw)
    # Bottom-up: the random PAF head also links fragments, so a frame holds
    # more instances than max_tracks lets in.
    assert_same_tracking(got, want, atol=1e-5 if type_set == "bottomup" else 1e-4,
                         all_tracked=type_set != "bottomup" or "max_tracks" not in CASES[case])
    if type_set != "bottomup":
        n_tracks = 1 if type_set == "single_instance" else 2
        assert len(got.tracks) == n_tracks
        assert sum(len(lf) for lf in got) == n_tracks * N_FRAMES
    assert got.provenance.get("tracking_config") == want.provenance.get("tracking_config")
    untracked = prun.predict(source(pio), paths, device="cpu", batch_size=4, **KW[type_set])
    assert "tracking_config" not in untracked.provenance
    assert all(i.track is None for lf in untracked for i in lf.instances)


def test_tracker_object_matches_jax(dirs, scipy_grouping):  # noqa: F811
    paths = _paths(dirs, "topdown")
    got = prun.predict(source(pio), paths, device="cpu", batch_size=4,
                       tracker=PTracker.from_config(window_size=2))
    want = jax_predict(source(jio), paths, batch_size=4,
                       tracker=JTracker.from_config(window_size=2))
    assert_same_tracking(got, want, atol=1e-4)


@pytest.mark.parametrize("kwargs,error", [
    ({"max_trakcs": 2}, TypeError),
    ({"tracking": True, "window": 3}, TypeError),
    ({"tracking": True, "centroid_output": "centroid"}, ValueError),
    ({"tracker": "any", "centroid_output": "both"}, ValueError),
])
def test_bad_tracker_knobs_raise_like_jax(dirs, kwargs, error):  # noqa: F811
    paths = _paths(dirs, "single_instance")
    with pytest.raises(error) as perr:
        prun.predict(source(pio), paths, device="cpu", **kwargs)
    with pytest.raises(error) as jerr:
        jax_predict(source(jio), paths, **kwargs)
    assert str(perr.value) == str(jerr.value)


def test_tracking_refuses_a_streamed_output_like_jax(dirs, tmp_path):  # noqa: F811
    paths = _paths(dirs, "single_instance")
    errs = []
    for fn, io, kw in ((prun.predict, pio, {"device": "cpu"}), (jax_predict, jio, {})):
        with pytest.raises(ValueError) as err:
            fn(source(io), paths, tracking=True, stream_to_file=tmp_path / "s.slp", **kw)
        errs.append(str(err.value))
    assert errs[0] == errs[1]
