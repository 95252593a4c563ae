"""A run of each cell with the timed path broken underneath: the harness's
look for a chip is skipped (a tiny configuration on the CPU), the rest of
the run is driven as ``run.py`` drives it, and ``correct`` has to come out
false. The sound run beside each has to come out true."""

import pytest

from portbench.core.run import load_module, result
from portbench.tests.tiny import SPEC, tiny_ctx
from portbench.tools.faults import altered_answers, half_batch, unchanged_state

PREDICT = [w["name"] for w in SPEC["workloads"] if w["traffic"].startswith("predict")]
TRAIN = [w["name"] for w in SPEC["workloads"] if w["traffic"].startswith("train")]


def correct(ctx, files, out):
    line, _ = result(ctx, out, files["end_to_end"], files["per_layer"],
                     {"platform": "cpu", "kind": "cpu", "count": 1})
    return line["correct"], line["checks"]


@pytest.mark.parametrize("cell", PREDICT)
@pytest.mark.parametrize("fault", [None, altered_answers], ids=["sound", "altered_answers"])
def test_predict_faults(cell, fault):
    ctx, files = tiny_ctx(cell, seed=21, seconds=1.0)
    entry = load_module(files["entry"])
    ok, checks = correct(ctx, files, entry.run(ctx) if fault is None else entry.run(ctx, fault))
    assert ok == (fault is None), checks


@pytest.mark.parametrize("cell", TRAIN)
@pytest.mark.parametrize("fault", [None, unchanged_state, half_batch],
                         ids=["sound", "unchanged_state", "half_batch"])
def test_training_faults(cell, fault):
    ctx, files = tiny_ctx(cell, seed=22, seconds=1.0)
    entry = load_module(files["entry"])
    ok, checks = correct(ctx, files, entry.run(ctx) if fault is None else entry.run(ctx, fault))
    assert ok == (fault is None), checks
