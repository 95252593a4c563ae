"""The control, at each cell's own size on the card: the plain reference in
the program's place, a precision below the configuration's (fp8 convs for
the bf16 predict mixes, TF32 for the float32 training mixes), has to come
out not correct, on three seeds. The benchmark's own runs never run it.

    python3 -m pytest -m cuda portbench/tests/test_portbench_control.py

(about 4 minutes on one H100; the cells' readings come from
``portbench/tools/readings.py``)."""

import time

import pytest

from portbench.core.run import RunContext, cell_files, judge_checks, load_module
from portbench.tests.tiny import ROOT, SPEC

CELLS = [w["name"] for w in SPEC["workloads"]]
SEEDS = (3900000001, 3900000002, 3900000003)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's own size on a CUDA device")
    from portbench.reference.control import control_layer

    files = cell_files(SPEC, cell, ROOT)
    entry = load_module(files["entry"])
    for seed in SEEDS:
        ctx = RunContext(workload=files["workload"], config=files["config"],
                         traffic=files["traffic"], limits=files["limits"], seed=seed,
                         seconds=4.0, trace=False, t_process=time.perf_counter())
        if files["traffic"]["entry"] == "train":
            checks = entry.run(ctx, with_control=True).record["control_checks"]
            checks = dict(checks, loader_mismatch=0, rows_repeated=0)
        else:
            checks = entry.run(ctx, control_layer).checks
        ok, rows = judge_checks(checks, files["limits"])
        assert not ok, rows
