"""Port parity: the native PAF grouping (``sleap_nn_tpu_torch/native/``)
against the JAX package's default path.

The JAX ``PAFScorer.group_sample`` runs ``sleap_nn_tpu/native/paf_group.cpp``
wherever g++ builds it and falls back to scipy only where it cannot. The
port does the same with its copy of the library. The grouping of both
packages' defaults must agree exactly, in instance order too: points,
peak values, instance scores and the matched edges. The inputs are the
15-node, 14-edge tree of ROADMAP fault F1 on seeds 0-299, as drawn and
with the scores rounded to multiples of 0.25 (ties, where the native and
scipy paths part most). The port's scipy fallback, with
``SLEAP_NN_TPU_NO_NATIVE`` set, must still equal the JAX package's
fallback.
"""

import multiprocessing
import re
import time

import numpy as np
import pytest

import sleap_nn_tpu.native
from sleap_nn_tpu.inference import paf_grouping as jpg
from sleap_nn_tpu_torch import native as tnative
from sleap_nn_tpu_torch.inference import paf_grouping as tpg

NAMES = [f"n{i}" for i in range(15)]
EDGES = [("n0", "n1"), ("n0", "n6"), ("n0", "n9"), ("n0", "n12"), ("n1", "n2"),
         ("n1", "n3"), ("n3", "n4"), ("n4", "n5"), ("n6", "n7"), ("n7", "n8"),
         ("n9", "n10"), ("n10", "n11"), ("n12", "n13"), ("n13", "n14")]
SEEDS = range(300)
BLOCK = 25


def f1_case(seed, tied=False):
    """ROADMAP F1's input: grouped peaks, values and dense scores of one
    sample with K = 2..9 candidates a node and 40% of the pairs invalid."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 10))
    gp = rng.uniform(0, 500, (15, k, 2)).astype(np.float32)
    gv = rng.random((15, k)).astype(np.float32)
    scores = rng.normal(0.4, 0.4, (14, k, k)).astype(np.float32)
    scores[rng.random(scores.shape) < 0.4] = -np.inf
    if tied:
        scores = (np.round(scores * 4) / 4).astype(np.float32)
    return gp, gv, scores


def _assert_same(got, want):
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got[3] == want[3]


def _group_both(seeds, tied, min_instance_peaks=0):
    kw = dict(part_names=NAMES, edges=EDGES, min_line_scores=0.25,
              min_instance_peaks=min_instance_peaks)
    js, ts = jpg.PAFScorer(**kw), tpg.PAFScorer(**kw)
    n_inst = 0
    for seed in seeds:
        gp, gv, sc = f1_case(seed, tied)
        want = js.group_sample(gp, gv, sc, return_matches=True)
        got = ts.group_sample(gp, gv, sc, return_matches=True)
        _assert_same(got, want)
        n_inst += len(got[0])
    return n_inst


def test_both_defaults_are_native():
    assert sleap_nn_tpu.native.get_lib() is not None
    assert tnative.get_lib() is not None


@pytest.mark.parametrize("tied", [False, True], ids=["drawn", "tied"])
@pytest.mark.parametrize("start", range(0, len(SEEDS), BLOCK))
def test_group_sample_matches_jax_default_in_order(start, tied):
    assert tnative.get_lib() is not None
    assert _group_both(range(start, start + BLOCK), tied) > BLOCK  # instances found


@pytest.mark.parametrize("min_instance_peaks", [3, 0.4])
def test_group_sample_min_instance_peaks_matches_jax_default(min_instance_peaks):
    assert _group_both(range(0, 300, 7), True, min_instance_peaks) > 0


def test_f1_seeds_part_from_the_scipy_path():
    """The default and the fallback differ on these inputs (ROADMAP F1), so
    the comparison above tells the two paths apart."""
    ts = tpg.PAFScorer(NAMES, EDGES)
    differ = 0
    for seed in SEEDS:
        gp, gv, sc = f1_case(seed)
        native = ts.group_sample(gp, gv, sc)
        matches = tpg.match_candidates_dense(sc, ts.min_line_scores)
        conns = {}
        for e, s, d, score in matches:
            conns.setdefault(e, []).append((s, d, score))
        assign = tpg.assign_connections_to_instances(conns, ts.edge_inds, ts.sorted_edge_inds)
        scipy = tpg.make_predicted_instances(gp, gv, conns, assign, ts.edge_inds, ts.n_nodes)
        differ += any(a.shape != b.shape or not np.array_equal(a, b, equal_nan=True)
                      for a, b in zip(native, scipy))
    assert differ > 0


@pytest.mark.parametrize("tied", [False, True], ids=["drawn", "tied"])
def test_scipy_fallback_matches_jax_fallback(monkeypatch, tied):
    monkeypatch.setattr(sleap_nn_tpu.native, "paf_group_sample_native", lambda *a, **k: None)
    monkeypatch.setenv("SLEAP_NN_TPU_NO_NATIVE", "1")
    assert tnative.get_lib() is None
    assert tnative.paf_group_sample_native(np.zeros((14, 2, 2), np.float32), [(0, 1)] * 14,
                                           range(14), 15, 0.25, 0) is None
    assert _group_both(range(0, 300, 3), tied) > 0


def test_library_builds_into_build_dir_under_a_hashed_name(monkeypatch, tmp_path):
    lib = tnative.library_path()
    assert lib.parent == tnative.SOURCE.parent.parent / "_build"
    assert re.fullmatch(r"paf_group-[0-9a-f]{16}\.so", lib.name)
    assert tnative.get_lib() is not None and lib.exists()
    assert not list(tnative.SOURCE.parent.glob("*.so"))  # nothing next to the source
    monkeypatch.setattr(tnative, "CXX_FLAGS", tnative.CXX_FLAGS + ["-g"])
    assert tnative.library_path() != lib  # other flags, another library
    # A build into an empty directory leaves the library and nothing else.
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "_build")
    assert tnative._build(tnative.library_path())
    assert [p.name for p in (tmp_path / "_build").iterdir()] == [tnative.library_path().name]


def _load_in_worker(build_dir, start_at):
    """Load the library from ``build_dir`` at ``start_at`` (a spawn worker)."""
    from pathlib import Path

    from sleap_nn_tpu_torch import native

    native.BUILD_DIR = Path(build_dir)
    time.sleep(max(0.0, start_at - time.time()))
    lib = native.get_lib()
    gp, gv, sc = f1_case(9)
    got = native.paf_group_sample_native(sc, [(0, 1)] * 14, range(14), 15, 0.25, 0)
    return (lib is not None, native.library_path().read_bytes(), got[2],
            native.build_log)


def test_two_spawn_workers_loading_at_once_get_a_whole_library(tmp_path):
    build_dir = tmp_path / "_build"
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(2) as pool:
        start_at = time.time() + 8.0  # both workers have imported by then
        res = pool.starmap(_load_in_worker, [(str(build_dir), start_at)] * 2)
    (ok0, bytes0, n0, log0), (ok1, bytes1, n1, log1) = res
    assert ok0 and ok1, (log0, log1)
    assert bytes0 == bytes1 and n0 == n1 > 0
    libs = list(build_dir.iterdir())
    assert [p.name for p in libs] == [tnative.library_path().name]  # no temporary left
    assert libs[0].read_bytes() == bytes0
