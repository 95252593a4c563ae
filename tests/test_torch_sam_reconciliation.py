"""The port's SAM reconciliation and ``retrack``
(``sleap_nn_tpu_torch/inference/sam/{reconciliation,retrack}.py``) against
the JAX package's on the same seeded scenarios: every assignment, swap,
id map, name and relabel must be equal, exactly (both are numpy + scipy).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from sleap_nn_tpu.inference.sam import reconciliation as jrec
from sleap_nn_tpu.inference.sam import retrack as jax_retrack
from sleap_nn_tpu.io import model as jio
from sleap_nn_tpu_torch.inference.sam import reconciliation as prec
from sleap_nn_tpu_torch.inference.sam import retrack as port_retrack
from sleap_nn_tpu_torch.io import model as pio
from tests.test_torch_pipeline import torch_threads  # noqa: F401 (autouse)

H, W = 48, 64
NODES = ["head", "thorax", "abdomen", "tail"]


def disk(cx, cy, r):
    yy, xx = np.mgrid[:H, :W]
    return (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r


def scenario(seed, n_frames=8, n_animals=3):
    """Animals on slow random walks; one mask per animal per frame whose
    object id is its identity, except that ids 0 and 1 swap from a random
    frame on (when ``seed`` is odd). Predicted instances carry the track of
    a shuffled identity (a tracker's swaps); a few frames hold user
    instances with the true tracks (anchors), some nodes are NaN, and one
    frame pads its masks with an id of -1."""
    rng = np.random.default_rng(seed)
    pos = rng.uniform([12, 12], [W - 12, H - 12], (n_animals, 2))
    swap_at = int(rng.integers(2, n_frames)) if seed % 2 else n_frames
    anchors = set(rng.choice(n_frames, size=2, replace=False).tolist())
    frames = []
    for f in range(n_frames):
        pos = np.clip(pos + rng.normal(0, 1.5, pos.shape), 10, [W - 10, H - 10])
        poses, masks, ids = [], [], []
        perm = rng.permutation(n_animals) if rng.random() < 0.3 else np.arange(n_animals)
        for a in range(n_animals):
            pts = pos[a] + rng.normal(0, 3, (len(NODES), 2))
            pts[rng.random(len(NODES)) < 0.15] = np.nan
            user = f in anchors and a < 2
            poses.append((pts, a if user else int(perm[a]), user))
            obj = a if f < swap_at or a > 1 else 1 - a
            masks.append(disk(*pos[a], 8 + a))
            ids.append(obj)
        if f == 3:  # padding row
            masks.append(np.zeros((H, W), bool))
            ids.append(-1)
        scores = rng.uniform(0.5, 1.0, len(ids)).astype(np.float32)
        frames.append((poses, np.stack(masks), np.array(ids), scores))
    return frames


def frames_in(io, scn):
    skel = io.Skeleton(NODES)
    tracks = [io.Track(name=f"animal{i}") for i in range(4)]
    out = []
    for f, (poses, _, _, _) in enumerate(scn):
        insts = []
        for pts, t, user in poses:
            if user:
                insts.append(io.Instance(np.array(pts), skel, track=tracks[t]))
            else:
                insts.append(io.PredictedInstance.from_numpy(
                    points=np.array(pts), skeleton=skel, point_scores=np.ones(len(NODES)),
                    score=0.9, track=tracks[t]))
        out.append(io.LabeledFrame(video=None, frame_idx=f, instances=insts))
    return out, skel


def plain(x):
    """Dataclasses and containers as plain values, for equality."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                if not f.name.startswith("_") and f.name not in ("resolver", "labeled_frames")}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple, set)):
        return [plain(v) for v in (sorted(x) if isinstance(x, set) else x)]
    if isinstance(x, np.generic):
        return x.item()
    return x


PREDICATES = [
    ("default", lambda m: []),
    ("min_two", lambda m: [m.require_min_keypoints_inside(2)]),
    ("fraction_and_area", lambda m: [m.require_min_fraction_inside(0.5),
                                     m.require_reasonable_mask_area(100, 2000)]),
    ("centroid", lambda m: [m.default_match_predicate, m.require_centroid_proximity(6.0)]),
]


@pytest.mark.parametrize("pred", [p[0] for p in PREDICATES])
@pytest.mark.parametrize("seed", range(4))
def test_id_reconciler_matches_jax(seed, pred):
    scn = scenario(seed)
    make = dict(PREDICATES)[pred]
    out = {}
    for name, io, rec in (("port", pio, prec), ("jax", jio, jrec)):
        lfs, skel = frames_in(io, scn)
        r = rec.IDReconciler(skeleton=skel, exclude_nodes={"tail"} if seed == 2 else set(),
                             match_predicates=make(rec), ignore_gt_tracks=seed == 3)
        per_frame = []
        for f, lf in enumerate(lfs):
            masks, ids, scores = scn[f][1], scn[f][2], scn[f][3]
            per_frame.append(plain(r.match_frame(f, lf.instances, masks[:, None] if f == 5
                                                 else masks, ids, scores)))
            per_frame.append(r.compute_cost_matrix(lf.instances, masks).tolist())
        out[name] = (per_frame, plain(r.detect_swaps()), plain(r.build_id_map()),
                     plain(r.get_assignments()))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("seed", range(4))
def test_mask_reconciler_matches_jax(seed):
    scn = scenario(seed)
    out = {}
    for name, rec in (("port", prec), ("jax", jrec)):
        r = rec.MaskReconciler(min_iou=0.2 + 0.1 * seed, track_names={0: "a", 2: "c"})
        rows = []
        for f in range(1, len(scn)):
            anchor_masks, anchor_ids = scn[f - 1][1], scn[f - 1][2]
            rows.append(plain(r.match_frame(f, anchor_masks, anchor_ids, scn[f][1], scn[f][2],
                                            scn[f][3])))
            rows.append(r.compute_cost_matrix(anchor_masks, scn[f][1][:, None]).tolist())
        rows.append(rec.MaskReconciler.compute_iou(scn[0][1][0], scn[1][1][0]))
        out[name] = (rows, plain(r.detect_swaps()), plain(r.build_id_map()), r.get_iou_stats(),
                     plain(r.get_assignments()))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("anchors", [{}, {4: {0: "a", 1: "b"}},
                                     {2: {0: "a"}, 8: {0: "b", 1: "c"}, 5: {2: "d"}}])
def test_track_name_resolver_and_votes_match_jax(anchors):
    out = {}
    for name, rec in (("port", prec), ("jax", jrec)):
        r = rec.TrackNameResolver.from_id_map(anchors, fallback_names={3: "z"})
        out[name] = (
            [(f, o, r.get_track_name(f, o), r.get_anchor_source(f), r.get_mapping_at_frame(f))
             for f in range(11) for o in range(4)],
            r.resolve_all_frames(10), r.get_anchor_frames(), sorted(r.get_all_track_names()),
            sorted(r.get_all_obj_ids()), r.get_canonical_mapping(),
            plain(rec.majority_vote_names({**anchors, 9: {0: "a", 2: "d"}, 10: {0: "b"}})))
    assert out["port"] == out["jax"]


@pytest.mark.parametrize("kw", [
    {},
    {"in_place": False, "exclude_nodes": {"tail"}},
    {"anchor_frame_indices": [0, 1], "fallback_names": {2: "animal3"}},
    {"match_predicates": "min_two", "scores": True},
])
@pytest.mark.parametrize("seed", range(4))
def test_retrack_matches_jax(seed, kw):
    scn = scenario(seed, n_frames=10)
    out = {}
    for name, io, rec, retrack in (("port", pio, prec, port_retrack),
                                   ("jax", jio, jrec, jax_retrack)):
        lfs, skel = frames_in(io, scn)
        args = dict(kw)
        if args.get("match_predicates") == "min_two":
            args["match_predicates"] = [rec.require_min_keypoints_inside(2)]
        if args.pop("scores", False):
            args["scores"] = [s[3] for s in scn]
        res = retrack(lfs, [s[1] for s in scn], [s[2] for s in scn], skel, **args)
        names = [[getattr(i.track, "name", None) for i in lf.instances]
                 for lf in res.labeled_frames]
        before = [[getattr(i.track, "name", None) for i in lf.instances] for lf in lfs]
        out[name] = (plain(res), names, before,
                     plain(res.resolver.gt_anchors) if res.resolver else None)
    assert out["port"] == out["jax"]
    assert out["port"][0]["num_matched"] > 0


def test_retrack_refuses_mismatched_lengths():
    lfs, skel = frames_in(pio, scenario(0, n_frames=2))
    for retrack in (port_retrack, jax_retrack):
        with pytest.raises(ValueError, match="length mismatch"):
            retrack(lfs, [np.zeros((1, H, W), bool)], [np.zeros(1)], skel)
    with pytest.raises(ValueError, match="scores length"):
        port_retrack(lfs, [np.zeros((1, H, W), bool)] * 2, [np.zeros(1)] * 2, skel,
                     scores=[np.ones(1)])
