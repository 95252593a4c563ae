"""Port parity: tracking segmentation masks (``features="masks"``,
``scoring_method="mask_iou"``) against the JAX package.

Scenes of disk masks moving across frames (crossing paths, an occlusion
longer than the window, an animal entering late, masks on the model's
grid beside image-resolution ones, an empty mask) are tracked by both
packages with the same knobs. Track assignments must be exactly equal;
tracking scores to 1e-12.
"""

import numpy as np
import pytest

from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.tracking import tracker as jtr
from sleap_nn_tpu.tracking import utils as jut
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.tracking import tracker as ptr
from sleap_nn_tpu_torch.tracking import utils as put
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

HW = 120


def _disk(cx, cy, r, hw=HW):
    yy, xx = np.mgrid[:hw, :hw]
    return (xx - cx) ** 2 + (yy - cy) ** 2 < r * r


def scene(kind, n=16):
    """Per frame: a list of (mask, score, scale)."""
    frames = []
    for t in range(n):
        objs = []
        if kind == "crossing":
            objs = [(_disk(10 + 6 * t, 50, 9), 0.9, 1.0), (_disk(110 - 6 * t, 56, 8), 0.8, 1.0)]
        elif kind == "occlusion":
            objs = [(_disk(15 + 3 * t, 30, 8), 0.9, 1.0)]
            if not 4 <= t < 12:
                objs.append((_disk(60, 20 + 4 * t, 7), 0.7, 1.0))
        elif kind == "entering":
            objs = [(_disk(20 + 2 * t, 20, 8), 0.9, 1.0), (_disk(90, 90 - 2 * t, 9), 0.6, 1.0)]
            if t >= 6:
                objs.append((_disk(50, 10 + 4 * t, 6), 0.5, 1.0))
        elif kind == "grid":
            # Masks on a stride-2 grid, and one image-resolution mask.
            objs = [(_disk(10 + 2 * t, 20, 5, HW // 2), 0.9, 2.0),
                    (_disk(40, 50 - t, 4, HW // 2), 0.8, 2.0),
                    (_disk(30 + 4 * t, 90, 8), 0.7, 1.0)]
        elif kind == "noisy":
            rng = np.random.default_rng(t)
            objs = [(_disk(20 + 3 * t + rng.normal(), 30 + rng.normal(), 7), 0.9, 1.0),
                    (_disk(70 + rng.normal(), 80 - 2 * t, 9), 0.8, 1.0),
                    (np.zeros((HW, HW), bool), 0.1, 1.0)]
            if t % 3 == 0:
                objs.append((_disk(*rng.uniform(10, 110, 2), 3), 0.2, 1.0))
        frames.append(objs)
    return frames


def build(io, frames):
    return io.Labels([io.LabeledFrame(None, t, [], masks=[
        io.SegmentationMask(m, score=s, scale=sc) for m, s, sc in objs])
        for t, objs in enumerate(frames)])


def tracked(labels):
    return ([[(getattr(m.track, "name", None), getattr(m, "tracking_score", None))
              for m in lf.masks] for lf in labels.labeled_frames],
            [t.name for t in labels.tracks])


def assert_same(got, want):
    (grows, gtracks), (wrows, wtracks) = got, want
    assert gtracks == wtracks and len(grows) == len(wrows)
    for g, w in zip(grows, wrows):
        assert [x[0] for x in g] == [x[0] for x in w]
        for (_, gs), (_, ws) in zip(g, w):
            assert (gs is None) == (ws is None)
            if gs is not None:
                assert abs(gs - ws) <= 1e-12


KNOBS = [
    {},
    {"window_size": 2},
    {"candidates_method": "local_queues", "max_tracks": 2},
    {"track_matching_method": "greedy"},
    {"min_new_track_points": 60, "min_match_points": 40},
    {"scoring_reduction": "max", "window_size": 3},
    {"scoring_reduction": "robust_quantile", "robust_best_instance": 0.5},
]


@pytest.mark.parametrize("kind", ["crossing", "occlusion", "entering", "grid", "noisy"])
@pytest.mark.parametrize("knobs", KNOBS, ids=lambda k: "-".join(k) or "default")
def test_mask_tracking_matches_jax(kind, knobs):
    frames = scene(kind)
    kw = {"features": "masks", "scoring_method": "mask_iou", **knobs}
    want = tracked(jtr.run_tracker(build(jio, frames), **kw))
    got = tracked(ptr.run_tracker(build(pio, frames), **kw))
    assert_same(got, want)
    assert len(got[1]) >= 1


def test_masks_feature_skips_empty_masks_and_frames():
    frames = scene("noisy", n=6)
    frames[2] = []
    for io, tr in ((jio, jtr), (pio, ptr)):
        labels = tr.Tracker.from_config(features="masks", scoring_method="mask_iou") \
            .track_labels(build(io, frames))
        assert all(m.track is None for lf in labels for m in lf.masks if m.area == 0)
    assert_same(tracked(ptr.Tracker.from_config(features="masks", scoring_method="mask_iou")
                        .track_labels(build(pio, frames))),
                tracked(jtr.Tracker.from_config(features="masks", scoring_method="mask_iou")
                        .track_labels(build(jio, frames))))


@pytest.mark.parametrize("scales", [(1.0, 1.0), (2.0, 1.0), (1.0, 4.0), (2.0, 2.0)])
def test_mask_features_and_iou_match(scales):
    rng = np.random.default_rng(int(scales[0] * 10 + scales[1]))
    a = _disk(*rng.uniform(30, 60, 2), 9, int(HW / scales[0]))
    b = _disk(*rng.uniform(30, 60, 2), 12, int(HW / scales[1])) | (rng.random(
        (int(HW / scales[1]),) * 2) < 0.02)
    fa = [ut.get_mask(io.SegmentationMask(a, scale=scales[0])) for io, ut in
          ((jio, jut), (pio, put))]
    fb = [ut.get_mask(io.SegmentationMask(b, scale=scales[1])) for io, ut in
          ((jio, jut), (pio, put))]
    for f in (fa, fb):
        np.testing.assert_array_equal(f[1].crop, f[0].crop)
        assert (f[1].y0, f[1].x0, f[1].area, f[1].scale) == (f[0].y0, f[0].x0, f[0].area,
                                                             f[0].scale)
    assert put.compute_mask_iou(fa[1], fb[1]) == jut.compute_mask_iou(fa[0], fb[0])
    assert put.compute_mask_iou(a, b) == jut.compute_mask_iou(a, b)
    assert put.count_valid_points(pio.SegmentationMask(a)) == \
        jut.count_valid_points(jio.SegmentationMask(a)) == int(a.sum())
    empty = np.zeros((4, 4), bool)
    assert put.compute_mask_iou(empty, empty) == jut.compute_mask_iou(empty, empty) == 1.0
    assert put.compute_mask_iou(empty, a) == jut.compute_mask_iou(empty, a) == 0.0
