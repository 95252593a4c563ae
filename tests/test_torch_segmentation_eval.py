"""Port parity: mask and semantic evaluation (``evaluation.py``) against the
JAX package.

Ground truth and predictions are frames of disk and ellipse masks drawn
from a numpy seed: matched pairs at several overlaps, misses, false
positives, a prediction covering two animals and two covering one, masks
on the model's grid (``scale`` 2) beside masks at image resolution, and
frames with masks on one side only. Every metric equals the JAX package's
(integer counts exactly, floats to 1e-12).
"""

import numpy as np
import pytest

from sleap_nn_tpu import evaluation as jev
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu.io.slp import save_slp as jax_save_slp
from sleap_nn_tpu_torch import evaluation as pev
from sleap_nn_tpu_torch.io import model as pio
from tests.test_torch_evaluation import assert_same
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

HW = 96


def _ellipse(cx, cy, rx, ry, hw=HW):
    yy, xx = np.mgrid[:hw, :hw]
    return ((xx - cx) / rx) ** 2 + ((yy - cy) / ry) ** 2 <= 1


def _halve(m):
    """A grid mask (``scale`` 2) of an image-resolution mask."""
    return m[::2, ::2]


def scene(seed, n_frames=5, grid=False):
    """Per frame: GT masks and predicted (mask, score, scale) triples."""
    rng = np.random.default_rng(seed)
    frames = []
    for f in range(n_frames):
        n = int(rng.integers(1, 4))
        cents = rng.uniform(15, HW - 15, (n, 2))
        radii = rng.uniform(4, 12, (n, 2))
        gt = [_ellipse(*c, *r) for c, r in zip(cents, radii)]
        pr = []
        for c, r in zip(cents, radii):
            if rng.random() < 0.2:
                continue  # a miss
            m = _ellipse(*(c + rng.normal(0, 1.5, 2)), *(r * rng.uniform(0.8, 1.2, 2)))
            if rng.random() < 0.2:  # split in two
                half = np.zeros_like(m)
                half[:, : int(c[0])] = True
                pr += [(m & half, float(rng.random()), 1.0), (m & ~half, float(rng.random()), 1.0)]
                continue
            pr.append((m, float(rng.random()), 1.0))
        if rng.random() < 0.5:  # a false positive
            pr.append((_ellipse(*rng.uniform(10, HW - 10, 2), 5, 5), float(rng.random()), 1.0))
        if grid:
            pr = [(_halve(m), s, 2.0) for m, s, _ in pr]
        if f == n_frames - 1:
            pr = []  # predictions only where the model found something
        frames.append((gt, pr))
    return frames


def build(io, frames, pred_instances=False):
    skel = io.Skeleton(["a"])
    gt, pr = [], []
    for f, (gms, pms) in enumerate(frames):
        user = [io.Instance(np.full((1, 2), 10.0 + f), skel)]
        gt.append(io.LabeledFrame(None, f, user, masks=[io.SegmentationMask(m) for m in gms]))
        insts = [io.PredictedInstance(np.full((1, 2), 11.0), skel, score=0.5)] \
            if pred_instances else []
        pr.append(io.LabeledFrame(None, f, insts, masks=[
            io.SegmentationMask(m, score=s, scale=sc) for m, s, sc in pms]))
    return io.Labels(gt, skeletons=[skel]), io.Labels(pr, skeletons=[skel])


SCENES = {"seed0": (0, False), "seed1": (1, False), "grid": (2, True), "seed3": (3, False)}


@pytest.mark.parametrize("name", sorted(SCENES))
@pytest.mark.parametrize("kw", [{"match_method": "mask"},
                                {"match_method": "mask", "match_threshold": 0.3},
                                {"match_method": "semantic"},
                                {"match_method": "mask", "user_labels_only": False}],
                         ids=["mask", "mask_thr", "semantic", "mask_all"])
def test_mask_evaluator_matches_jax(name, kw):
    seed, grid = SCENES[name]
    frames = scene(seed, grid=grid)
    (jgt, jpr), (pgt, ppr) = build(jio, frames), build(pio, frames)
    jevl, pevl = jev.Evaluator(jgt, jpr, **kw), pev.Evaluator(pgt, ppr, **kw)
    assert len(pevl.frame_pairs) == len(jevl.frame_pairs)
    assert [(g.frame_idx, o) for g, _, o in pevl.positive_pairs] == \
        [(g.frame_idx, o) for g, _, o in jevl.positive_pairs]
    assert len(pevl.false_negatives) == len(jevl.false_negatives)
    assert len(pevl.false_positives) == len(jevl.false_positives)
    assert_same(jevl.evaluate(), pevl.evaluate())
    if kw["match_method"] == "mask":
        assert pevl.mask_metrics()["n_matched"] >= 3
        assert_same(jevl._fragmentation_counts(0.3), pevl._fragmentation_counts(0.3))
        thr = np.array([0.3, 0.6])
        assert_same(jevl.mask_voc_metrics(thr, np.linspace(0, 1, 11), (25.0, 75.0)),
                    pevl.mask_voc_metrics(thr, np.linspace(0, 1, 11), (25.0, 75.0)))


@pytest.mark.parametrize("method", ["mask", "semantic", "oks"])
def test_run_evaluation_on_slp_files_matches_jax(method, tmp_path):
    frames = scene(1)
    (jgt, jpr), (pgt, ppr) = build(jio, frames, True), build(pio, frames, True)
    jax_save_slp(tmp_path / "gt.slp", jgt)
    jax_save_slp(tmp_path / "pr.slp", jpr)
    want = jev.run_evaluation(str(tmp_path / "gt.slp"), str(tmp_path / "pr.slp"),
                              match_method=method, save_metrics=str(tmp_path / "j.npz"))
    got = pev.run_evaluation(str(tmp_path / "gt.slp"), str(tmp_path / "pr.slp"),
                             match_method=method, save_metrics=str(tmp_path / "p.npz"))
    assert_same(want, got)
    assert_same(jev.load_metrics(tmp_path / "p.npz"), pev.load_metrics(tmp_path / "j.npz"))
    # In memory, the same.
    assert_same(pev.run_evaluation(pgt, ppr, match_method=method),
                jev.run_evaluation(jgt, jpr, match_method=method))


def test_run_evaluation_without_masks_returns_none():
    frames = [(gt, []) for gt, _ in scene(0)]
    for ev, io in ((jev, jio), (pev, pio)):
        gt, pr = build(io, frames, pred_instances=True)
        assert ev.run_evaluation(gt, pr, match_method="mask") is None
        assert ev.run_evaluation(gt, pr, match_method="semantic") is None
        assert ev.run_evaluation(gt, pr, match_method="oks") is not None


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mask_primitives_match(seed):
    rng = np.random.default_rng(seed)
    a = _ellipse(*rng.uniform(20, 60, 2), 10, 7)
    b = _ellipse(*rng.uniform(20, 60, 2), 9, 12) | (rng.random((HW, HW)) < 0.01)
    assert pev.mask_iou(a, b) == jev.mask_iou(a, b)
    assert pev.mask_iou(np.zeros((3, 3)), np.zeros((3, 3))) == 0.0
    for r in (0.02, 0.05):
        assert pev.boundary_iou(a, b, r) == jev.boundary_iou(a, b, r)
    assert pev.mask_cldice(a, b) == jev.mask_cldice(a, b)
    np.testing.assert_array_equal(pev._skeletonize(b), jev._skeletonize(b))
    gts, prs = [a, b, _ellipse(5, 5, 3, 3)], [b, a | b, _ellipse(80, 80, 4, 4)]
    assert pev.match_masks(gts, prs, 0.4) == jev.match_masks(gts, prs, 0.4)
    assert pev.match_masks([], prs) == jev.match_masks([], prs)
    areas = rng.uniform(10, 2e4, 30)
    areas[3] = np.nan
    edges = pev._percentile_size_edges(areas)
    np.testing.assert_array_equal(edges, jev._percentile_size_edges(areas))
    for i in range(3):
        np.testing.assert_array_equal(pev._size_mask(areas, i, edges),
                                      jev._size_mask(areas, i, edges))
