"""Port parity: PAF scoring and grouping (sleap_nn_tpu_torch.inference.paf_grouping,
inference.streaming).

The device half is held against the JAX package's ``score_paf_lines_dense``
under ``jax.jit``, the production form (``BottomUpLayer`` runs it jitted):
XLA contracts the line point ``src + t * disp`` into one fused multiply-add,
and a subscript on a ``.5`` boundary rounds by that single rounding. Both
the gather path and the Pallas kernel (``SLEAP_NN_TPU_PALLAS=1``, interpret
mode) are compared. Tolerance: 1e-5 absolute on finite scores (sums in
another order), ``-inf`` placement exact.

The host half is held against the JAX package's scipy path (its C++
grouping is switched off), which must give identical instances.

``PAFScorer``'s cached line fractions are held bit for bit against
``jnp.linspace``.
"""

import itertools
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sleap_nn_tpu.native
from sleap_nn_tpu.inference import paf_grouping as jpg
from sleap_nn_tpu.inference import streaming as jstream
from sleap_nn_tpu_torch.inference import paf_grouping as tpg
from sleap_nn_tpu_torch.inference import streaming as tstream
from sleap_nn_tpu_torch.ops.kernels import _plain_paf_line_scores, paf_line_scores


def _jax_scores(pafs, peaks, mask, edges, **kw):
    # A fresh function per call: SLEAP_NN_TPU_PALLAS is read while tracing.
    fn = jax.jit(lambda *a: jpg.score_paf_lines_dense(*a, **kw))
    return np.asarray(fn(jnp.asarray(pafs), jnp.asarray(peaks), jnp.asarray(mask),
                         jnp.asarray(edges)))


def _port_scores(pafs, peaks, mask, edges, dtype, **kw):
    return tpg.score_paf_lines_dense(
        torch.from_numpy(pafs).to(dtype), torch.from_numpy(peaks), torch.from_numpy(mask),
        torch.from_numpy(edges), **kw).numpy()


def _assert_scores_match(got, want):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    fin = np.isfinite(want)
    assert np.isfinite(got[fin]).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0, atol=1e-5)


def _hard_inputs(seed, b=2, hp=12, wp=14, n_nodes=5, k=6, stride=4):
    """Peaks with every hard case: NaN (masked and unmasked), masked finite,
    off the map, src == dst, and coordinates on ``.5`` subscript boundaries."""
    rng = np.random.default_rng(seed)
    edges = np.array([(0, 1), (1, 2), (0, 3), (3, 4), (2, 2)], np.int32)
    pafs = rng.standard_normal((b, hp, wp, 2 * len(edges)), dtype=np.float32)
    # Half the peaks on a grid of stride / 2: x / stride lands on k + 0.5.
    grid = rng.integers(-2, 2 * max(hp, wp) + 2, (b, n_nodes, k, 2)) * (stride / 2)
    cont = rng.uniform(-3 * stride, (max(hp, wp) + 3) * stride, (b, n_nodes, k, 2))
    peaks = np.where(rng.random((b, n_nodes, k, 1)) < 0.5, grid, cont).astype(np.float32)
    mask = rng.random((b, n_nodes, k)) < 0.8
    peaks[0, 1, 0] = peaks[0, 0, 0]  # src == dst: zero length
    mask[0, 1, 0] = mask[0, 0, 0] = True
    peaks[0, 2, 1] = np.nan  # NaN with the mask on: -inf by the finite check
    mask[0, 2, 1] = True
    peaks[1, 3, 2] = np.nan  # NaN and masked
    mask[1, 3, 2] = False
    peaks[1, 0, 3] = [-50.0, wp * stride + 70.0]  # far off the map
    mask[1, 0, 3] = True
    return pafs, peaks, mask, edges


@pytest.mark.parametrize("pallas", [False, True], ids=["gather", "pallas"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("seed,n_points,stride", [(0, 10, 4), (1, 7, 2), (2, 20, 4)])
def test_scores_match_jitted_jax(monkeypatch, seed, n_points, stride, dtype, pallas):
    monkeypatch.setenv("SLEAP_NN_TPU_PALLAS", "1" if pallas else "0")
    pafs, peaks, mask, edges = _hard_inputs(seed, stride=stride)
    jpafs = jnp.asarray(pafs).astype(jnp.bfloat16) if dtype == torch.bfloat16 else pafs
    kw = dict(n_line_points=n_points, pafs_stride=stride)
    want = _jax_scores(jpafs, peaks, mask, edges, **kw)
    got = _port_scores(pafs, peaks, mask, edges, dtype, **kw)
    _assert_scores_match(got, want)
    assert np.isfinite(want).sum() > 50 and np.isneginf(want).sum() > 10


@pytest.mark.parametrize("stride,n_points", [(4, 10), (3, 7), (2, 20), (8, 10)])
def test_scores_match_jitted_jax_at_many_pairs(stride, n_points):
    """Many random lines: enough points that some lie within an FMA's
    rounding of a ``.5`` boundary, where two roundings would differ."""
    rng = np.random.default_rng(stride * 100 + n_points)
    b, hp, wp, n_edges, n_nodes, k = 4, 64, 64, 14, 15, 20
    pafs = rng.standard_normal((b, hp, wp, 2 * n_edges), dtype=np.float32)
    peaks = rng.uniform(-10, hp * stride + 10, (b, n_nodes, k, 2)).astype(np.float32)
    mask = rng.random((b, n_nodes, k)) > 0.1
    edges = np.array([(i, (i * 7 + 3) % n_nodes) for i in range(n_edges)], np.int32)
    kw = dict(n_line_points=n_points, pafs_stride=stride)
    want = _jax_scores(pafs, peaks, mask, edges, **kw)
    _assert_scores_match(_port_scores(pafs, peaks, mask, edges, torch.float32, **kw), want)


def test_line_points_round_once_like_jit():
    """A line point whose two-rounding value lands on a ``.5`` subscript:
    22.755487 + t[3] * (44.48902 - 22.755487) is 29.999998 rounded once
    (subscript 7) and 30.0 rounded twice (7.5, subscript 8). The port
    follows the jitted reference, not eager JAX."""
    pafs = np.zeros((1, 4, 16, 2), np.float32)
    pafs[..., 0] = np.arange(16, dtype=np.float32)  # x channel = x subscript
    peaks = np.full((1, 2, 1, 2), 8.0, np.float32)
    peaks[0, 0, 0, 0], peaks[0, 1, 0, 0] = 22.755487, 44.48902
    mask = np.ones((1, 2, 1), bool)
    edges = np.array([(0, 1)], np.int32)
    kw = dict(n_line_points=10, pafs_stride=4, max_edge_length_ratio=10.0)
    jitted = _jax_scores(pafs, peaks, mask, edges, **kw)
    eager = np.asarray(jpg.score_paf_lines_dense(
        jnp.asarray(pafs), jnp.asarray(peaks), jnp.asarray(mask), jnp.asarray(edges), **kw))
    np.testing.assert_allclose(eager - jitted, 0.1, atol=1e-6)  # one sample, 8 vs 7
    _assert_scores_match(_port_scores(pafs, peaks, mask, edges, torch.float32, **kw), jitted)


@pytest.mark.parametrize("n_points", range(1, 65))
def test_line_fractions_are_jnp_linspace_bit_for_bit(n_points):
    want = np.asarray(jnp.linspace(0.0, 1.0, n_points))
    got = tpg.line_fractions(n_points).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_wrapper_takes_the_plain_version_on_cpu_and_checks_shapes():
    pafs, peaks, mask, edges = _hard_inputs(3)
    args = (torch.from_numpy(pafs), torch.from_numpy(peaks), torch.from_numpy(mask),
            torch.from_numpy(edges), tpg.line_fractions(10), 4, 16.0, 1.0)
    torch.testing.assert_close(paf_line_scores(*args), _plain_paf_line_scores(*args),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="2E"):
        paf_line_scores(args[0][..., :-1], *args[1:])
    with pytest.raises(ValueError, match="grouped_mask"):
        paf_line_scores(args[0], args[1], args[2][:, :-1], *args[3:])


@pytest.mark.parametrize("k_per_node", [1, 3, 8])
def test_group_peaks_by_node_exact(k_per_node):
    rng = np.random.default_rng(k_per_node)
    b, k_in, n_nodes = 3, 24, 4
    peaks = rng.uniform(0, 100, (b, k_in, 2)).astype(np.float32)
    vals = np.sort(rng.random((b, k_in)).astype(np.float32), axis=1)[:, ::-1].copy()
    chan = rng.integers(-1, n_nodes, (b, k_in)).astype(np.int32)
    chan[0, :12] = 2  # more than k_per_node peaks on one node
    valid = (chan >= 0) & (rng.random((b, k_in)) < 0.9)
    peaks[~valid] = np.nan
    want = jax.jit(jpg.group_peaks_by_node, static_argnums=(4, 5))(
        jnp.asarray(peaks), jnp.asarray(vals), jnp.asarray(chan), jnp.asarray(valid),
        n_nodes, k_per_node)
    got = tpg.group_peaks_by_node(torch.from_numpy(peaks), torch.from_numpy(vals),
                                  torch.from_numpy(chan), torch.from_numpy(valid),
                                  n_nodes, k_per_node)
    for g, w in zip(got, want):
        g, w = g.numpy(), np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert all(g.is_contiguous() for g in got)  # as the CUDA scoring kernel takes them
    assert got[2][0, 2].all()  # the crowded node filled every slot


@pytest.mark.parametrize("edges", [
    [(0, 1), (1, 2), (1, 3), (3, 4)],  # tree
    [(0, 1), (0, 2), (1, 3), (2, 4), (2, 5), (4, 6)],  # tree, branched
    [(3, 1), (1, 0), (3, 2), (2, 4)],  # root not node 0
    [(0, 1), (1, 2), (3, 4), (4, 5)],  # forest
    [(5, 4), (0, 1), (4, 3)],  # forest, second root first
    [(0, 1), (0, 2), (1, 3), (2, 3), (3, 4)],  # DAG, two paths to 3
    [(0, 2), (1, 2), (2, 3)],  # DAG, two roots
    [(0, 1), (1, 2), (2, 0)],  # full cycle
    [(0, 1), (1, 0), (2, 0)],  # partial cycle
    [(0, 1), (1, 1), (1, 2)],  # self-loop
    [(0, 1), (0, 1), (1, 2)],  # repeated edge
], ids=lambda e: "-".join(f"{s}{d}" for s, d in e))
def test_toposort_edges_matches_networkx_order(edges):
    assert tpg.toposort_edges(edges) == jpg.toposort_edges(edges)


def test_toposort_edges_cyclic_cases():
    assert tpg.toposort_edges([(0, 1), (1, 2), (2, 0)]) == (0, 1, 2)
    assert tpg.toposort_edges([(0, 1), (1, 0), (2, 0)]) == (2, 0, 1)


@pytest.fixture
def scipy_grouping(monkeypatch):
    """The JAX package's scipy grouping path (its C++ path switched off)."""
    monkeypatch.setattr(sleap_nn_tpu.native, "paf_group_sample_native", lambda *a, **k: None)


def _grouping_case(seed, n_nodes=6, k=5):
    """Dense scores of instances laid out along a skeleton, plus clutter."""
    rng = np.random.default_rng(seed)
    names = [f"n{i}" for i in range(n_nodes)]
    edges = [("n0", "n1"), ("n1", "n2"), ("n0", "n3"), ("n3", "n4"), ("n4", "n5")]
    n_edges = len(edges)
    b = 3
    gp = rng.uniform(0, 200, (b, n_nodes, k, 2)).astype(np.float32)
    gv = rng.random((b, n_nodes, k)).astype(np.float32)
    scores = rng.uniform(-1.0, 1.0, (b, n_edges, k, k)).astype(np.float32)
    for i in range(b):
        n_inst = i + 2
        for e in range(n_edges):
            scores[i, e, :n_inst, :n_inst] += np.eye(n_inst, dtype=np.float32) * 2
    scores[rng.random(scores.shape) < 0.15] = -np.inf
    scores[0, 2] = -np.inf  # an edge with no candidates
    gp[2, 4, 3:] = np.nan
    gv[2, 4, 3:] = 0
    scores[2, 3, :, 3:] = scores[2, 4, 3:, :] = -np.inf
    return names, edges, gp, gv, scores


@pytest.mark.parametrize("min_instance_peaks", [0, 3, 0.5])
@pytest.mark.parametrize("seed", [0, 1])
def test_group_sample_matches_jax(scipy_grouping, seed, min_instance_peaks):
    names, edges, gp, gv, scores = _grouping_case(seed)
    kw = dict(part_names=names, edges=edges, min_line_scores=0.25,
              min_instance_peaks=min_instance_peaks)
    js, ts = jpg.PAFScorer(**kw), tpg.PAFScorer(**kw)
    assert ts.sorted_edge_inds == js.sorted_edge_inds
    n_found = 0
    for i in range(gp.shape[0]):
        want = js.group_sample(gp[i], gv[i], scores[i], return_matches=True)
        got = ts.group_sample(gp[i], gv[i], scores[i], return_matches=True)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[3] == want[3]
        n_found += len(got[0])
    assert n_found >= 3


@pytest.mark.parametrize("max_instances,return_paf_graph", [(None, False), (2, True)])
def test_group_batch_host_matches_jax(scipy_grouping, max_instances, return_paf_graph):
    names, edges, gp, gv, scores = _grouping_case(2)
    payload = {"grouped_peaks": gp, "grouped_vals": gv, "scores": scores, "lift": 0.5,
               "pafs": np.ones((3, 4, 4, 10), np.float32)}
    want = jstream.group_batch_host(payload, jpg.PAFScorer(names, edges), max_instances,
                                    return_paf_graph=return_paf_graph)
    got = tstream.group_batch_host(payload, tpg.PAFScorer(names, edges), max_instances,
                                   return_paf_graph=return_paf_graph)
    assert set(got) == set(want)
    for key in want:
        if key == "pafs":
            assert got[key] is payload["pafs"]
            continue
        for g, w in zip(got[key], want[key]):
            for a, c in zip(g if key == "pred_paf_graph" else [g],
                            w if key == "pred_paf_graph" else [w]):
                np.testing.assert_array_equal(a, c)
    if max_instances:
        assert max(len(p) for p in got["pred_keypoints"]) == max_instances


def test_grouping_pool_keeps_submission_order():
    names, edges, gp, gv, scores = _grouping_case(3)
    scorer = tpg.PAFScorer(names, edges)
    payloads = [{"grouped_peaks": gp[i:i + 1], "grouped_vals": gv[i:i + 1],
                 "scores": scores[i:i + 1], "lift": 1.0} for i in range(3)]
    with tstream.PafGroupingPool(2, scorer, max_instances=None) as pool:
        for i, p in enumerate(payloads):
            pool.submit(i, p)
        done = list(pool.iter_completed())
    assert [o for o, _ in done] == [0, 1, 2]
    for (_, got), p in zip(done, payloads):
        want = tstream.group_batch_host(p, scorer, None)
        for a, c in itertools.zip_longest(got["pred_keypoints"], want["pred_keypoints"]):
            np.testing.assert_array_equal(a, c)
    with pytest.raises(ValueError, match="n_workers"):
        tstream.PafGroupingPool(0, scorer)


@pytest.mark.parametrize("n_points", range(1, 41))
def test_scorer_caches_line_fractions_bit_for_bit(n_points):
    scorer = tpg.PAFScorer(["a", "b"], [("a", "b")], n_points=n_points)
    t = scorer._line_fractions_on(torch.device("cpu"))
    want = np.asarray(jnp.linspace(0.0, 1.0, n_points))
    assert t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy().view(np.int32), want.view(np.int32))
    assert scorer._line_fractions_on(torch.device("cpu")) is t  # made once
    assert pickle.loads(pickle.dumps(scorer))._device_t == {}  # and not shipped to workers
