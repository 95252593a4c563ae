"""Port parity: predictions -> ``Labels`` (``Predictor.to_labels``,
``_frames_from_out``, ``_make_instance``), the instance filters
(``inference/filters.py``), ``LabelsProvider``, the labels data model's
edits (``io/model.py``) and the provenance builders, against the JAX
package.

Batch output dicts are made from a numpy seed in the layouts of the
single-instance, top-down and bottom-up layers, with padded rows
(``valid`` False), invalid and all-NaN instances, partly-NaN instances and
two videos. Both packages turn the same dicts into ``Labels``: frame order,
video slots, frame indices, instances, points (NaN placed exactly),
visibility, point scores and instance scores must be equal. Provenance
holds times, hosts and versions, so it is compared by key (the JAX
package's version keys under the port's names).
"""

from types import SimpleNamespace as ns

import numpy as np
import pytest
import torch

from sleap_nn_tpu.inference import filters as jfilt
from sleap_nn_tpu.inference import provenance as jprov
from sleap_nn_tpu.inference.predictor import Predictor as JaxPredictor
from sleap_nn_tpu.inference.providers import LabelsProvider as JLabelsProvider
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu_torch.inference import filters as pfilt
from sleap_nn_tpu_torch.inference import provenance as pprov
from sleap_nn_tpu_torch.inference.predictor import Predictor
from sleap_nn_tpu_torch.inference.providers import LabelsProvider
from sleap_nn_tpu_torch.io import model as pio

N_NODES, B = 4, 4
RENAME = {"sleap_nn_tpu_version": "sleap_nn_tpu_torch_version", "jax_version": "torch_version"}


class FrameVideo:
    def __init__(self, frames):
        self.frames = frames
        self.shape = frames.shape

    def __len__(self):
        return len(self.frames)

    def __getitem__(self, idx):
        return self.frames[idx]


def _points(rng, *shape, nan_p=0.2):
    pts = rng.uniform(0, 64, (*shape, N_NODES, 2)).astype(np.float32)
    pts[rng.random((*shape, N_NODES)) < nan_p] = np.nan
    return pts


def batch_outputs(model_type, seed=0, n_batches=3, n_frames=10):
    """Per-batch output dicts of one layer type: ``n_frames`` frames over two
    videos, the last batch padded."""
    rng = np.random.default_rng(seed)
    out = []
    for b in range(n_batches):
        first = b * B
        n_valid = max(0, min(B, n_frames - first))
        valid = np.arange(B) < n_valid
        d = {"frame_inds": np.asarray([first + min(i, n_valid - 1) for i in range(B)],
                                      np.int64),
             "video_inds": (rng.random(B) < 0.5).astype(np.int32), "valid": valid}
        if model_type == "single_instance":
            pts = _points(rng, B, 1)
            pts[1, 0] = np.nan  # a frame without an instance
            d.update(pred_keypoints=pts,
                     pred_peak_values=np.where(np.isnan(pts[..., 0]), 0,
                                               rng.random((B, 1, N_NODES))).astype(np.float32))
        elif model_type == "topdown":
            k = 3
            pts = _points(rng, B, k)
            inst_valid = rng.random((B, k)) < 0.7
            pts[~inst_valid] = np.nan
            pts[0, 0] = np.nan  # valid but all NaN: dropped
            d.update(pred_keypoints=pts,
                     pred_peak_values=rng.random((B, k, N_NODES)).astype(np.float32),
                     pred_centroids=rng.uniform(0, 64, (B, k, 2)).astype(np.float32),
                     centroid_vals=rng.random((B, k)).astype(np.float32),
                     instance_valid=inst_valid)
        else:
            counts = rng.integers(0, 4, B)
            kps = [_points(rng, int(n)) for n in counts]
            if counts[0]:
                kps[0][0] = np.nan
            d.update(pred_keypoints=kps,
                     pred_peak_values=[np.where(np.isnan(k[..., 0]), np.nan,
                                                rng.random(k.shape[:2])).astype(np.float32)
                                       for k in kps],
                     pred_instance_scores=[rng.random(int(n)).astype(np.float32)
                                           for n in counts])
        out.append(d)
    return out


def _predictors(model_type, pfilters=None, jfilters=None):
    names = [f"n{i}" for i in range(N_NODES)]
    edges = [(0, 1), (1, 2), (2, 3)]
    jp = JaxPredictor(None, model_type, jio.Skeleton(names, edges), [], B)
    jp.filters = jfilters
    layer = ns(device=torch.device("cpu"))
    pp = Predictor(layer, model_type, pio.Skeleton(names, edges), [], B, device="cpu",
                   filters=pfilters)
    return pp, jp


def assert_same_labels(got, want):
    assert len(got.labeled_frames) == len(want.labeled_frames)
    gv = {id(v): i for i, v in enumerate(got.videos)}
    wv = {id(v): i for i, v in enumerate(want.videos)}
    for g, w in zip(got.labeled_frames, want.labeled_frames):
        assert (g.frame_idx, gv.get(id(g.video))) == (w.frame_idx, wv.get(id(w.video)))
        assert len(g.instances) == len(w.instances)
        for gi, wi in zip(g.instances, w.instances):
            assert type(gi).__name__ == type(wi).__name__
            np.testing.assert_array_equal(gi.points, wi.points)
            np.testing.assert_array_equal(gi.visible, wi.visible)
            np.testing.assert_array_equal(gi.point_scores, wi.point_scores)
            assert gi.score == wi.score and gi.tracking_score == wi.tracking_score
            assert gi.skeleton.node_names == wi.skeleton.node_names


@pytest.mark.parametrize("model_type", ["single_instance", "topdown", "bottomup"])
@pytest.mark.parametrize("seed", [0, 1])
def test_to_labels_matches_jax(model_type, seed):
    results = batch_outputs(model_type, seed)
    frames = np.zeros((12, 8, 8, 1), np.uint8)
    pv, jv = [FrameVideo(frames), FrameVideo(frames)], [FrameVideo(frames), FrameVideo(frames)]
    pp, jp = _predictors(model_type)
    got = pp.to_labels(results, labels_src=pio.Labels(videos=pv))
    want = jp.to_labels(results, labels_src=jio.Labels(videos=jv))
    assert_same_labels(got, want)
    assert got.videos == pv and len(got.labeled_frames) > 3
    # No frame from a padded row; frames keep batch order.
    n_valid = sum(int(r["valid"].sum()) for r in results)
    assert len(got.labeled_frames) <= n_valid
    assert set(got.provenance) == {RENAME.get(k, k) for k in want.provenance}
    assert got.provenance["models"] == want.provenance["models"] == []
    # The device the predictor ran on, not whether the machine has a card.
    assert got.provenance["backend"] == "cpu"


def test_to_labels_of_one_video_and_of_no_video():
    results = batch_outputs("topdown", 3)
    pp, jp = _predictors("topdown")
    video = FrameVideo(np.zeros((12, 8, 8, 1), np.uint8))
    for kw in ({"video": video}, {}):
        results = [dict(r, video_inds=np.zeros(B, np.int32)) for r in results]
        got, want = pp.to_labels(results, **kw), jp.to_labels(results, **kw)
        assert_same_labels(got, want)
        assert all(lf.video is kw.get("video") for lf in got)


FILTERS = [
    {"min_node_count": 3},
    {"min_node_confidence": 0.4},
    {"min_instance_score": 0.5},
    {"overlap_method": "iou", "overlap_threshold": 0.3},
    {"overlap_method": "oks", "overlap_threshold": 0.2},
    {"max_centroid_distance": 15.0},
    {"min_visible_node_fraction": 0.7},
    {"min_mean_node_score": 0.5},
    {"min_node_confidence": 0.3, "min_node_count": 2, "overlap_method": "iou",
     "overlap_threshold": 0.5},
]


def _instances(io, seed, n=8):
    rng = np.random.default_rng(seed)
    skel = io.Skeleton([f"n{i}" for i in range(N_NODES)])
    centers = rng.uniform(10, 40, (3, 2))
    out = []
    for i in range(n):
        pts = centers[i % 3] + rng.normal(0, 4, (N_NODES, 2))
        pts[rng.random(N_NODES) < 0.2] = np.nan
        out.append(io.PredictedInstance(pts, skel, point_scores=rng.random(N_NODES),
                                        score=float(rng.random())))
    return out


@pytest.mark.parametrize("cfg", FILTERS, ids=lambda c: "+".join(c))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_filters_match_jax(cfg, seed):
    got = pfilt.FilterPipeline(pfilt.FilterConfig(**cfg)).apply(_instances(pio, seed))
    want = jfilt.FilterPipeline(jfilt.FilterConfig(**cfg)).apply(_instances(jio, seed))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.points, w.points)
        np.testing.assert_array_equal(g.visible, w.visible)
        assert g.score == w.score
    assert pfilt.FilterConfig(**cfg).enabled() and not pfilt.FilterConfig().enabled()


def test_suppress_overlapping_refuses_an_unknown_method():
    for mod, io in ((pfilt, pio), (jfilt, jio)):
        with pytest.raises(ValueError, match="Invalid overlap method"):
            mod.suppress_overlapping(_instances(io, 0), "area", 0.5)


@pytest.mark.parametrize("model_type", ["topdown", "bottomup"])
def test_to_labels_applies_the_filters_like_jax(model_type):
    cfg = {"min_node_count": 3, "overlap_method": "oks", "overlap_threshold": 0.1}
    results = batch_outputs(model_type, 5)
    video = FrameVideo(np.zeros((12, 8, 8, 1), np.uint8))
    pp, jp = _predictors(model_type, pfilt.FilterConfig(**cfg), jfilt.FilterConfig(**cfg))
    results = [dict(r, video_inds=np.zeros(B, np.int32)) for r in results]
    got, want = pp.to_labels(results, video=video), jp.to_labels(results, video=video)
    assert_same_labels(got, want)
    unfiltered = _predictors(model_type)[0].to_labels(results, video=video)
    assert sum(map(len, got)) < sum(map(len, unfiltered))


def test_make_instance_matches_jax():
    rng = np.random.default_rng(4)
    pts, vals = _points(rng, 1)[0], rng.random(N_NODES).astype(np.float32)
    vals[0] = np.nan
    skel_p, skel_j = pio.Skeleton(["a", "b", "c", "d"]), jio.Skeleton(["a", "b", "c", "d"])
    for score in (None, 0.25):
        g = Predictor._make_instance(pts, vals, skel_p, score=score)
        w = JaxPredictor._make_instance(pts, vals, skel_j, score=score)
        np.testing.assert_array_equal(g.points, w.points)
        np.testing.assert_array_equal(g.point_scores, w.point_scores)
        assert g.score == w.score
    empty = Predictor._make_instance(np.full((N_NODES, 2), np.nan), vals, skel_p)
    assert empty.score == 0.0


def _two_video_labels(io, seed=0):
    rng = np.random.default_rng(seed)
    videos = [FrameVideo(rng.integers(0, 256, (6, 8, 8, 1), dtype=np.uint8)) for _ in range(2)]
    skel = io.Skeleton(["a", "b"], edges=[(0, 1)])
    lfs = []
    for f in range(7):
        video = videos[f % 2]
        insts = [io.Instance(rng.uniform(0, 8, (2, 2)), skel)] if f % 3 else []
        if f in (2, 4):
            insts.append(io.PredictedInstance(rng.uniform(0, 8, (2, 2)), skel, score=0.5))
        lfs.append(io.LabeledFrame(video, f // 2, insts))
    return io.Labels(lfs, videos=videos)


@pytest.mark.parametrize("batch_size", [3, 4])
def test_labels_provider_matches_jax(batch_size):
    got = list(LabelsProvider(_two_video_labels(pio), batch_size=batch_size))
    want = list(JLabelsProvider(_two_video_labels(jio), batch_size=batch_size))
    assert len(got) == len(want) >= 1
    for g, w in zip(got, want):
        for key in ("frames", "frame_inds", "video_inds", "valid"):
            np.testing.assert_array_equal(getattr(g, key), getattr(w, key), err_msg=key)
    assert not got[-1].valid.all()


def test_labels_edits_match_jax():
    p, j = _two_video_labels(pio), _two_video_labels(jio)

    def shape(labels):
        vid = {id(v): i for i, v in enumerate(labels.videos)}
        return [(vid[id(lf.video)], lf.frame_idx, len(lf.user_instances),
                 len(lf.predicted_instances), lf.has_predicted_instances)
                for lf in labels.labeled_frames]

    assert shape(p) == shape(j)
    assert len(p.negative_frames) == len(j.negative_frames) >= 1
    assert len(p.user_labeled_frames) == len(j.user_labeled_frames)
    assert [lf.frame_idx for lf in p[1:4]] == [lf.frame_idx for lf in j[1:4]]
    assert p[(p.videos[1], 1)].frame_idx == j[(j.videos[1], 1)].frame_idx == 1
    with pytest.raises(KeyError):
        p[(p.videos[1], 99)]
    assert len(p.find(p.videos[0])) == len(j.find(j.videos[0]))
    assert len(list(p.instances())) == len(list(j.instances()))
    for lp, lj in zip(p, j):
        np.testing.assert_array_equal(lp.numpy(), lj.numpy())
        for ip, ij in zip(lp.instances, lj.instances):
            np.testing.assert_array_equal(ip.bounding_box(), ij.bounding_box())
            np.testing.assert_array_equal(ip.centroid(), ij.centroid())
            np.testing.assert_array_equal(ip.centroid("b"), ij.centroid("b"))
    for seed, n in ((0, 3), (1, 0.5)):
        (pa, pb), (ja, jb) = p.split(n, seed=seed), j.split(n, seed=seed)
        assert shape(pa) == shape(ja) and shape(pb) == shape(jb)
    extra = pio.LabeledFrame(p.videos[0], 9, [])
    p.append(extra)
    j.append(jio.LabeledFrame(j.videos[0], 9, []))
    p.extend([pio.LabeledFrame(p.videos[1], 8, [])])
    j.extend([jio.LabeledFrame(j.videos[1], 8, [])])
    assert shape(p) == shape(j)
    p.clean(empty_instances=True, tracks=True, videos=True)
    j.clean(empty_instances=True, tracks=True, videos=True)
    assert shape(p) == shape(j) and len(p.videos) == len(j.videos)
    # The JAX package's clean(skeletons=True) puts skeletons in a set, which
    # raises (Skeleton defines __eq__, so it is unhashable); the port keeps
    # the skeletons that instances use.
    with pytest.raises(TypeError, match="unhashable"):
        j.clean(skeletons=True)
    unused = pio.Skeleton(["z"])
    p.skeletons.append(unused)
    p.clean(skeletons=True)
    assert p.skeletons == [p.labeled_frames[1].instances[0].skeleton]
    p.remove_predictions()
    j.remove_predictions()
    assert shape(p) == shape(j)
    assert not any(lf.has_predicted_instances for lf in p)


def test_predicted_instance_from_numpy_and_roi_match_jax():
    rng = np.random.default_rng(7)
    pts, sc = rng.uniform(0, 9, (3, 2)), rng.random(3)
    track_p, track_j = pio.Track("t"), jio.Track("t")
    g = pio.PredictedInstance.from_numpy(pts, sc, pio.Skeleton(["a", "b", "c"]), score=0.3,
                                         track=track_p, tracking_score=0.9)
    w = jio.PredictedInstance.from_numpy(pts, sc, jio.Skeleton(["a", "b", "c"]), score=0.3,
                                         track=track_j, tracking_score=0.9)
    assert repr(g) == repr(w)
    np.testing.assert_array_equal(g.point_scores, w.point_scores)
    poly = rng.uniform(0, 9, (5, 2))
    assert pio.PredictedROI(poly).area == jio.PredictedROI(poly).area
    assert len(pio.PredictedROI(poly)) == 5
    assert pio.Skeleton(["a"]).matches(pio.Skeleton(["a"]))
    s = pio.SuggestionFrame(video=None, frame_idx=3, group=1)
    assert (s.frame_idx, s.group) == (3, 1)


def test_provenance_matches_jax_by_key(tmp_path):
    model = tmp_path / "m"
    model.mkdir()
    (model / "training_config.yaml").write_text("a: 1\n")
    from datetime import datetime

    t0, t1 = datetime(2026, 1, 1, 0, 0, 0), datetime(2026, 1, 1, 0, 1, 0)
    labels = pio.Labels(provenance={"filename": "in.slp"})
    jlabels = jio.Labels(provenance={"filename": "in.slp"})
    kw = dict(model_type="topdown", start_time=t0, end_time=t1,
              input_path=tmp_path / "in.slp", frames_processed=5, frames_total=9,
              frame_selection_method="all", inference_params={"peak_threshold": 0.2,
                                                              "x": None},
              tracking_params={"a": 1}, device="cpu", cli_args={"b": 2})
    got = pprov.build_inference_provenance([model], {"fps": 1.0}, {"extra": 1},
                                           input_labels=labels, **kw)
    want = jprov.build_inference_provenance([model], {"fps": 1.0}, {"extra": 1},
                                            input_labels=jlabels, **kw)
    assert set(got) == {RENAME.get(k, k) for k in want}
    same = set(want) - {"sleap_nn_tpu_version", "jax_version", "platform", "python",
                        "backend", "timestamp", "system_info"}
    assert {k: got[k] for k in same} == {k: want[k] for k in same}
    assert {"torch_version", "cuda_version", "accelerator", "device_count"} <= \
        set(got["system_info"])
    assert got["backend"] is None
    assert pprov.build_inference_provenance(backend="cuda")["backend"] == "cuda"
    got_t = pprov.build_tracking_only_provenance(labels, tmp_path / "in.slp", t0, t1, {"a": 1},
                                                 5)
    want_t = jprov.build_tracking_only_provenance(jlabels, tmp_path / "in.slp", t0, t1,
                                                  {"a": 1}, 5)
    assert set(got_t) == {RENAME.get(k, k) for k in want_t}
    base, extra = {"a": 1, "b": 2}, {"b": 3, "c": 4}
    for overwrite in (True, False):
        assert pprov.merge_provenance(base, extra, overwrite) == \
            jprov.merge_provenance(base, extra, overwrite)
    assert base == {"a": 1, "b": 2}


def test_system_info_never_raises(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("no driver")

    monkeypatch.setattr(torch.cuda, "is_available", boom)
    info = pprov._system_info_fields()
    assert info["accelerator"] is None and info["torch_version"] == torch.__version__
