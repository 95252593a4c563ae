"""Port parity: ``evaluation.py`` (OKS, matching, VOC, PCK, distances,
visibility, the centroid mode, ``run_evaluation`` and the npz metrics
file) against the JAX package.

The cases mirror ``tests/test_evaluation.py``, ``test_evaluation_edges.py``,
``test_evaluation_matrix.py`` and ``test_metrics_file_interop.py``, plus
random scenes made from a numpy seed. Each builds the same ground-truth and
predicted labels in both packages' ``Labels``; every metric must be exactly
equal, of the same type, with NaNs in the same places. Each package's
``load_metrics`` reads the other's npz; ``run_evaluation`` agrees from
``.slp`` paths (h5py). The mask half is held here in brief and in
``tests/test_torch_segmentation_eval.py`` in full.
"""

import json

import numpy as np
import pytest

from sleap_nn_tpu import evaluation as jev
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.io import video as jvideo
from sleap_nn_tpu_torch import evaluation as pev
from sleap_nn_tpu_torch.io import model as pio
from sleap_nn_tpu_torch.io import video as pvideo
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

PACKAGES = ((jev, jio, jvideo), (pev, pio, pvideo))


def assert_same(a, b, path="metrics"):
    """Exact equality of nested metrics: same types, keys, shapes, dtypes,
    values, NaNs in the same places."""
    assert type(a) is type(b), (path, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (path, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (float, np.floating)) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def tri(x, y, spread=10.0):
    return [[x, y], [x + spread, y], [x, y + spread]]


def build(io, video_mod, frames, n_videos=1, nodes=("a", "b", "c"), pr_nodes=None):
    """``frames``: ``{"gt": [...], "pr": [...]}``, each a list of
    ``(video, frame_idx, [(kind, points, score), ...])`` with kind ``user``
    or ``pred``. Both labels share the videos."""
    videos = [video_mod.Video(filename=f"v{i}.mp4") for i in range(n_videos)]
    skel = io.Skeleton(nodes=list(nodes))
    pr_skel = io.Skeleton(nodes=list(pr_nodes)) if pr_nodes else skel
    out = []
    for key, sk in (("gt", skel), ("pr", pr_skel)):
        lfs = []
        for vi, fidx, insts in frames[key]:
            made = []
            for kind, pts, score in insts:
                pts = np.asarray(pts, float)
                if kind == "user":
                    made.append(io.Instance(points=pts, skeleton=sk))
                else:
                    made.append(io.PredictedInstance(points=pts, skeleton=sk,
                                                     point_scores=np.ones(len(sk)), score=score))
            lfs.append(io.LabeledFrame(videos[vi], fidx, made))
        out.append(io.Labels(lfs, videos=list(videos), skeletons=[sk]))
    return out


def u(pts):
    return ("user", pts, 1.0)


def p(pts, score=1.0):
    return ("pred", pts, score)


def one(gt, pr, fidx=0):
    return {"gt": [(0, fidx, gt)], "pr": [(0, fidx, pr)]}


def random_scene(seed, n_frames=8, n_nodes=5, n_videos=2):
    """Frames over two videos with 0-4 GT instances each; predictions are
    noisy copies (some missed, some spurious, NaN nodes, random scores)."""
    rng = np.random.default_rng(seed)
    gt, pr = [], []
    for f in range(n_frames):
        vi = int(rng.integers(n_videos))
        g_insts, p_insts = [], []
        for _ in range(int(rng.integers(0, 5))):
            pts = rng.uniform(0, 200, 2) + rng.normal(0, 12, (n_nodes, 2))
            pts[rng.random(n_nodes) < 0.15] = np.nan
            g_insts.append(u(pts))
            if rng.random() < 0.8:
                q = pts + rng.normal(0, rng.choice([0.5, 3.0, 15.0]), pts.shape)
                q[rng.random(n_nodes) < 0.1] = np.nan
                p_insts.append(p(q, float(rng.uniform(0.1, 1.0))))
        for _ in range(int(rng.integers(0, 2))):
            q = rng.uniform(0, 200, 2) + rng.normal(0, 12, (n_nodes, 2))
            p_insts.append(p(q, float(rng.uniform(0.1, 1.0))))
        if rng.random() < 0.2:  # a predicted instance on a user frame
            g_insts.append(p(rng.uniform(0, 200, (n_nodes, 2)), 0.5))
        gt.append((vi, f, g_insts))
        if rng.random() < 0.9:
            pr.append((vi, f, p_insts))
    return {"gt": gt, "pr": pr}


def _pts(x):
    return np.asarray(x, float)


SCENES = {
    "perfect": (one([u(tri(0, 0, 20)), u(tri(100, 100, 30))],
                    [p(tri(0, 0, 20)), p(tri(100, 100, 30))]), {}),
    "fn_and_1px": (one([u(tri(0, 0, 20)), u(tri(100, 100, 30))],
                       [p(_pts(tri(0, 0, 20)) + 1.0)]), {}),
    "higher_score_wins": (one([u(tri(0, 0))], [p(_pts(tri(0, 0)) + 0.5, 0.9),
                                               p(tri(0, 0), 0.1)]), {}),
    "user_and_pred_frames": ({"gt": [(0, 0, [u(tri(10, 10, 40)), p(tri(10, 10, 40), 0.9)]),
                                     (0, 1, [p(tri(20, 20, 40), 0.9)])],
                              "pr": [(0, 0, [p(tri(10, 10, 40), 0.9)]),
                                     (0, 1, [p(tri(20, 20, 40), 0.9)])]}, {}),
    "threshold_high": (one([u(tri(10, 10, 40))], [p(tri(14, 14, 40), 0.9)]),
                       {"match_threshold": 0.999999}),
    "three_frames": ({"gt": [(0, i, [u(tri(10 + i, 10, 40))]) for i in range(3)],
                      "pr": [(0, i, [p(tri(10 + i, 10.5, 40), 0.9)]) for i in range(3)]}, {}),
    "offset_3_4": (one([u(tri(10, 10, 40))], [p(tri(13, 14, 40), 0.9)]), {}),
    "unmatched_frame": ({"gt": [(0, 0, [u(tri(10, 10))]), (0, 5, [u(tri(10, 10))])],
                         "pr": [(0, 0, [p(tri(10, 10))])]}, {}),
    "two_videos": ({"gt": [(0, 0, [u(tri(10, 10))]), (1, 0, [u(tri(50, 50))])],
                    "pr": [(0, 0, [p(tri(10, 10))]), (1, 0, [p(tri(50, 50))])]}, {}),
    "best_oks_first": (one([u(tri(10, 10)), u(tri(100, 100))],
                           [p(tri(100.5, 100.5), 0.9), p(tri(10.2, 10.2), 0.8)]), {}),
    "surplus_pred": (one([u(tri(10, 10))], [p(tri(10, 10)), p(tri(200, 200), 0.4)]), {}),
    "missed_gt": (one([u(tri(10, 10)), u(tri(120, 120))], [p(tri(10, 10))]), {}),
    "loose_match": (one([u(tri(10, 10))], [p(tri(18, 18))]), {"match_threshold": 0}),
    "tight_match": (one([u(tri(10, 10))], [p(tri(18, 18))]), {"match_threshold": 0.9}),
    "mixed_offsets": (one([u(tri(10, 10))], [p(_pts(tri(10, 10)) + [[1, 0], [0, 2], [3, 0]])]),
                      {}),
    "pck_4px": (one([u(tri(10, 10))], [p(_pts(tri(10, 10)) + [4.0, 0.0])]), {}),
    "missed_node": (one([u(tri(10, 10))], [p([[10, 10], [20, 10], [np.nan, np.nan]])]), {}),
    "voc_perfect": ({"gt": [(0, i, [u(tri(10 + i, 10))]) for i in range(4)],
                     "pr": [(0, i, [p(tri(10 + i, 10))]) for i in range(4)]}, {}),
    "unmatchable_top_score": (one([u(tri(10, 10))], [p(tri(10, 10), 0.9),
                                                     p(tri(200, 200), 0.95)]), {}),
    "scale_loose": (one([u(tri(10, 10))], [p(_pts(tri(10, 10)) + [2.0, 0.0])]),
                    {"oks_scale": 10000.0}),
    "scale_tight": (one([u(tri(10, 10))], [p(_pts(tri(10, 10)) + [2.0, 0.0])]),
                    {"oks_scale": 10.0}),
    "stddev_fine": (one([u(tri(10, 10))], [p(_pts(tri(10, 10)) + [2.0, 0.0])]),
                    {"oks_stddev": 0.01}),
    "stddev_coarse": (one([u(tri(10, 10))], [p(_pts(tri(10, 10)) + [2.0, 0.0])]),
                      {"oks_stddev": 0.2}),
    "centroid_near": (one([u(tri(10, 10)), u(tri(100, 100))], [p(tri(11, 11)), p(tri(99, 99))]),
                      {"match_method": "centroid"}),
    "centroid_far": (one([u(tri(10, 10))], [p(tri(300, 300))]), {"match_method": "centroid"}),
    "centroid_anchor": (one([u(tri(10, 10))],
                            [p(_pts(tri(10, 10)) + [[0, 0], [30, 30], [30, 30]])]),
                        {"match_method": "centroid", "anchor_part": "n0"}),
    "centroid_threshold": (one([u(tri(10, 10)), u(tri(60, 60))], [p(tri(14, 10)), p(tri(70, 60))]),
                           {"match_method": "centroid", "match_threshold": 5.0}),
    "all_user_labels": ({"gt": [(0, 0, [u(tri(10, 10)), p(tri(50, 50), 0.7)]),
                                (0, 1, [p(tri(20, 20), 0.8)])],
                         "pr": [(0, 0, [p(tri(10, 10)), p(tri(50, 51), 0.6)]),
                                (0, 1, [p(tri(20, 21), 0.8)])]},
                        {"user_labels_only": False}),
    "no_pairs": ({"gt": [(0, 0, [u(tri(10, 10))])], "pr": [(0, 3, [p(tri(10, 10))])]}, {}),
    **{f"random_{s}": (random_scene(s), {}) for s in range(6)},
    **{f"random_{s}_centroid": (random_scene(s), {"match_method": "centroid"})
       for s in range(2)},
    "random_0_all_labels": (random_scene(0), {"user_labels_only": False}),
    "random_1_threshold": (random_scene(1), {"match_threshold": 0.5}),
}


def _labels_pair(frames):
    n_videos = 1 + max(vi for key in ("gt", "pr") for vi, _, _ in frames[key])
    n_nodes = next(len(pts) for key in ("gt", "pr") for _, _, insts in frames[key]
                   for _, pts, _ in insts)
    nodes = tuple(f"n{i}" for i in range(n_nodes))
    return [build(io, vid, frames, n_videos=n_videos, nodes=nodes) for _, io, vid in PACKAGES]


@pytest.mark.parametrize("name", sorted(SCENES))
def test_evaluator_matches_jax(name):
    frames, kw = SCENES[name]
    (jgt, jpr), (pgt, ppr) = _labels_pair(frames)
    jevl, pevl = jev.Evaluator(jgt, jpr, **kw), pev.Evaluator(pgt, ppr, **kw)
    assert len(pevl.frame_pairs) == len(jevl.frame_pairs)
    assert len(pevl.positive_pairs) == len(jevl.positive_pairs)
    assert [(g.frame_idx, g.video_path, o) for g, _, o in pevl.positive_pairs] == [
        (g.frame_idx, g.video_path, o) for g, _, o in jevl.positive_pairs]
    assert len(pevl.false_negatives) == len(jevl.false_negatives)
    assert len(pevl.false_positives) == len(jevl.false_positives)
    assert_same(jevl.evaluate(), pevl.evaluate())
    assert_same(jevl.detection_metrics(), pevl.detection_metrics())
    if kw.get("match_method") != "centroid":
        assert_same(jevl.voc_metrics("pck"), pevl.voc_metrics("pck"))
        th = np.array([0.5, 2.0, 4.5])
        assert_same(jevl.pck_metrics(th), pevl.pck_metrics(th))


@pytest.mark.parametrize("name", ["perfect", "fn_and_1px", "random_2", "random_3",
                                  "centroid_near", "random_1_centroid"])
def test_run_evaluation_matches_jax(name, tmp_path):
    frames, kw = SCENES[name]
    (jgt, jpr), (pgt, ppr) = _labels_pair(frames)
    jm = jev.run_evaluation(jgt, jpr, save_metrics=str(tmp_path / "j.npz"), **kw)
    pm = pev.run_evaluation(pgt, ppr, save_metrics=str(tmp_path / "p.npz"), **kw)
    assert_same(jm, pm)
    # Each package reads the other's npz, and its own, to the same dict.
    for path in ("j.npz", "p.npz"):
        assert_same(jev.load_metrics(tmp_path / path), pev.load_metrics(tmp_path / path))
    assert_same(pev.load_metrics(tmp_path / "j.npz"), pev.load_metrics(tmp_path / "p.npz"))
    assert (json.loads((tmp_path / "j.json").read_text())
            == json.loads((tmp_path / "p.json").read_text()))


@pytest.mark.parametrize("name", ["perfect", "random_4", "centroid_anchor"])
def test_run_evaluation_from_slp_paths(name, tmp_path):
    frames, kw = SCENES[name]
    (jgt, jpr), (pgt, ppr) = _labels_pair(frames)
    paths = {}
    for tag, labels in (("gt", pgt), ("pr", ppr)):
        paths[tag] = tmp_path / f"{tag}.slp"
        labels.save(str(paths[tag]))
    jm = jev.run_evaluation(str(paths["gt"]), str(paths["pr"]), **kw)
    pm = pev.run_evaluation(str(paths["gt"]), str(paths["pr"]), **kw)
    assert_same(jm, pm)
    assert_same(pev.run_evaluation(pgt, ppr, **kw), pm)


def test_run_evaluation_empty_and_auto():
    (jgt, jpr), (pgt, ppr) = _labels_pair(SCENES["perfect"][0])
    assert jev.run_evaluation(jgt, jio.Labels([])) is None
    assert pev.run_evaluation(pgt, pio.Labels([])) is None
    empty = {"gt": SCENES["perfect"][0]["gt"], "pr": [(0, 0, [])]}
    (jgt2, jpr2), (pgt2, ppr2) = _labels_pair(empty)
    assert jev.run_evaluation(jgt2, jpr2) is None and pev.run_evaluation(pgt2, ppr2) is None
    # "auto" picks the centroid mode for a one-node predicted skeleton.
    got = []
    for ev, io, vid in PACKAGES:
        gt, _ = build(io, vid, {"gt": [(0, 0, [u(tri(0, 0, 20))])], "pr": []})
        skel1 = io.Skeleton(nodes=["centroid"])
        pr = io.Labels([io.LabeledFrame(gt.videos[0], 0, [io.PredictedInstance(
            points=np.array([[11.0, 11.0]]), skeleton=skel1, score=1.0)])],
            videos=gt.videos, skeletons=[skel1])
        got.append(ev.run_evaluation(gt, pr, match_method="auto"))
    assert set(got[1]) == {"detection_metrics", "distance_metrics"}
    assert_same(*got)


# -- primitives ------------------------------------------------------------------


def _oks_inputs():
    rng = np.random.default_rng(3)
    g = rng.uniform(0, 50, (3, 4, 2))
    pr = g[[2, 0]] + rng.normal(0, 2, (2, 4, 2))
    g[0, 1] = np.nan
    pr[1, 3] = np.nan
    return [
        (np.array([[[0.0, 0.0], [10.0, 10.0]]]), np.array([[[3.0, 4.0], [13.0, 14.0]]]), {}),
        (np.array([[[0.0, 0.0], [10.0, 10.0], [np.nan, np.nan]]]),
         np.array([[[0.0, 0.0], [np.nan, np.nan], [np.nan, np.nan]]]), {}),
        (np.array(tri(0, 0), float), np.array(tri(0, 0), float) + 1.0, {"scale": 4.0}),
        (np.array([tri(0, 0)], float), np.array([tri(0, 0)], float) + [3.0, 0.0],
         {"use_cocoeval": False}),
        (g, pr, {}), (g, pr, {"stddev": 0.1}), (g, pr, {"scale": 30.0}),
        (np.full((1, 3, 2), np.nan), np.array([tri(0, 0)], float), {}),
        (np.array([tri(0, 0)], float), np.full((1, 3, 2), np.nan), {}),
    ]


@pytest.mark.parametrize("case", range(len(_oks_inputs())))
def test_compute_oks_and_area_match_jax(case):
    g, pr, kw = _oks_inputs()[case]
    with np.errstate(invalid="ignore", divide="ignore"):
        assert_same(jev.compute_oks(g, pr, **kw), pev.compute_oks(g, pr, **kw))
        assert_same(jev.compute_instance_area(g), pev.compute_instance_area(g))


@pytest.mark.parametrize("threshold", [0.0, 0.5, 0.999999])
def test_match_instances_and_frame_pairs_match_jax(threshold):
    (jgt, jpr), (pgt, ppr) = _labels_pair(random_scene(5, n_frames=10))
    for user_only in (True, False):
        jp = jev.find_frame_pairs(jgt, jpr, user_labels_only=user_only)
        pp = pev.find_frame_pairs(pgt, ppr, user_labels_only=user_only)
        assert [(g.frame_idx, len(g.instances), len(r.instances)) for g, r in pp] == [
            (g.frame_idx, len(g.instances), len(r.instances)) for g, r in jp]
    for (jg, jr), (pg, pr) in zip(jp, pp):
        jpos, jfn = jev.match_instances(jg, jr, threshold=threshold)
        ppos, pfn = pev.match_instances(pg, pr, threshold=threshold)
        assert [(jg.instances.index(g.instance), jr.instances.index(r.instance), o)
                for g, r, o in jpos] == [
            (pg.instances.index(g.instance), pr.instances.index(r.instance), o)
            for g, r, o in ppos]
        assert len(pfn) == len(jfn)


def test_centroid_helpers_match_jax():
    (jgt, _), (pgt, _) = _labels_pair(random_scene(7))
    for anchor in (None, "n1"):
        jc = jev.compute_gt_centroids(jgt, anchor_part=anchor)
        pc = pev.compute_gt_centroids(pgt, anchor_part=anchor)
        assert_same([jc[k] for k in jc], [pc[k] for k in pc])
    rng = np.random.default_rng(1)
    g, pr = rng.uniform(0, 100, (5, 2)), rng.uniform(0, 100, (4, 2))
    g[2] = np.nan
    for thr in (5.0, 30.0, 200.0):
        assert_same(jev.match_centroids(g, pr, thr), pev.match_centroids(g, pr, thr))
    assert_same(jev.match_centroids(g[:0], pr), pev.match_centroids(g[:0], pr))


def test_size_buckets_and_ap_match_jax():
    rng = np.random.default_rng(2)
    areas = rng.uniform(10, 20000, 40)
    areas[3] = np.nan
    assert_same(jev._percentile_size_edges(areas), pev._percentile_size_edges(areas))
    assert_same(jev._percentile_size_edges([]), pev._percentile_size_edges([]))
    for edges in (jev.COCO_SIZE_EDGES, jev._percentile_size_edges(areas)):
        for i in range(3):
            assert_same(jev._size_mask(areas, i, edges), pev._size_mask(areas, i, edges))
    scores = rng.uniform(0, 1, 30)
    scores[5] = scores[9]  # a tie, broken by the stable sort
    matched = rng.random(30) < 0.6
    rt = np.linspace(0, 1, 101)
    for n_gt in (0, 25, 40):
        assert_same(jev._ap_from_pr(scores, matched, n_gt, rt),
                    pev._ap_from_pr(scores, matched, n_gt, rt))
    assert_same(jev._ap_from_pr(scores[:0], matched[:0], 5, rt),
                pev._ap_from_pr(scores[:0], matched[:0], 5, rt))


# -- the metrics file ---------------------------------------------------------------


NESTED = {
    "mOKS": {"mOKS": 0.91},
    "voc_metrics": {"oks_voc.mAP": 0.5},
    "distance_metrics": {"avg": 2.5, "dists": np.array([1.0, 4.0]), "p50": np.float64("nan")},
}


@pytest.mark.parametrize("name", ["metrics.val.0.npz", "val_0_pred_metrics.npz",
                                  "metrics.val_0.npz", "metrics.test.0.npz"])
def test_load_metrics_finds_each_naming_alike(name, tmp_path):
    pev.save_metrics_npz(NESTED, tmp_path / name)
    for split in ("test", "val"):
        try:
            want = jev.load_metrics(tmp_path, split=split)
        except FileNotFoundError:
            with pytest.raises(FileNotFoundError):
                pev.load_metrics(tmp_path, split=split)
            continue
        assert_same(want, pev.load_metrics(tmp_path, split=split))


def test_metrics_file_formats_match_jax(tmp_path):
    jev.save_metrics_npz(NESTED, tmp_path / "j.npz")
    pev.save_metrics_npz(NESTED, tmp_path / "p.npz")
    assert (tmp_path / "p.json").read_text() == (tmp_path / "j.json").read_text()
    d = json.loads((tmp_path / "p.json").read_text())
    assert "dists" not in d["distance_metrics"] and d["distance_metrics"]["p50"] is None
    for f in ("j.npz", "p.npz"):
        assert_same(jev.load_metrics(tmp_path / f), pev.load_metrics(tmp_path / f))
    # The per-group (old) and flat formats, written by hand.
    np.savez(tmp_path / "old.npz", mOKS=np.asarray({"mOKS": 0.7}, dtype=object),
             flat=np.arange(3.0))
    assert_same(jev.load_metrics(tmp_path / "old.npz"), pev.load_metrics(tmp_path / "old.npz"))
    for ev in (jev, pev):
        with pytest.raises(FileNotFoundError):
            ev.load_metrics(tmp_path / "missing.npz")
    nan_inf = {"mOKS": {"mOKS": np.float64("nan"), "inf": np.float32("inf")}}
    jev.save_metrics_npz(nan_inf, tmp_path / "jn.npz")
    pev.save_metrics_npz(nan_inf, tmp_path / "pn.npz")
    assert (tmp_path / "pn.json").read_text() == (tmp_path / "jn.json").read_text()
    assert_same(jev._flatten(NESTED), pev._flatten(NESTED))


# -- the mask half (tests/test_torch_segmentation_eval.py holds it in full) --------


def _with_masks(io, labels, seed):
    """Each frame gets one mask per instance: a disk around its first node."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:200, :200]
    for lf in labels.labeled_frames:
        lf.masks = []
        for inst in lf.instances:
            c = np.nan_to_num(np.asarray(inst.points)[0]) + rng.uniform(-3, 3, 2)
            lf.masks.append(io.SegmentationMask((xx - c[0]) ** 2 + (yy - c[1]) ** 2 < 150,
                                                score=float(rng.random())))
    return labels


@pytest.mark.parametrize("call", [
    lambda ev, gt, pr: ev.Evaluator(gt, pr, match_method="mask").evaluate(),
    lambda ev, gt, pr: ev.Evaluator(gt, pr, match_method="semantic").evaluate(),
    lambda ev, gt, pr: ev.run_evaluation(gt, pr, match_method="semantic"),
    lambda ev, gt, pr: ev.Evaluator(gt, pr, match_method="mask").mask_metrics(),
    lambda ev, gt, pr: ev.Evaluator(gt, pr, match_method="mask").mask_voc_metrics(),
    lambda ev, gt, pr: ev.Evaluator(gt, pr, match_method="semantic").semantic_metrics(),
    lambda ev, gt, pr: ev.mask_iou(gt[0].masks[0].mask, pr[0].masks[0].mask),
    lambda ev, gt, pr: ev.match_masks([m.mask for m in gt[0].masks],
                                      [m.mask for m in pr[0].masks]),
    lambda ev, gt, pr: ev.boundary_iou(gt[0].masks[0].mask, pr[0].masks[0].mask),
    lambda ev, gt, pr: ev.mask_cldice(pr[0].masks[0].mask, gt[0].masks[0].mask),
])
def test_mask_evaluation_raises_naming_item_10(call):
    # Mask evaluation is ported: each call gives what the JAX package gives.
    (jgt, jpr), (pgt, ppr) = _labels_pair(SCENES["perfect"][0])
    want = call(jev, _with_masks(jio, jgt, 0), _with_masks(jio, jpr, 1))
    got = call(pev, _with_masks(pio, pgt, 0), _with_masks(pio, ppr, 1))
    assert_same(want, got)


def test_labels_with_masks_raise_naming_item_10():
    # Labels that carry masks are evaluated, pose and masks alike, as in JAX.
    (jgt, jpr), (pgt, ppr) = _labels_pair(SCENES["perfect"][0])
    jgt.labeled_frames[0].masks = [np.ones((4, 4), bool)]
    pgt.labeled_frames[0].masks = [np.ones((4, 4), bool)]
    for method in ("oks", "mask"):
        assert_same(jev.Evaluator(jgt, jpr, match_method=method).evaluate(),
                    pev.Evaluator(pgt, ppr, match_method=method).evaluate())
