"""Tiny configurations for the CPU tests: the cells' files with small
sizes, so that a run's whole path (set-up, window, reader, judge) fits in
a few seconds on the CPU."""

from __future__ import annotations

import copy
import time

from portbench.core.run import PKG, RunContext, cell_files, load_json

ROOT = PKG.parent
SPEC = load_json(ROOT / "BENCHMARK.json")

SMALL_UNET = {"filters": 4, "filters_rate": 1.5, "max_stride": 8}


def tiny_files(workload: str):
    """The cell's files with the sizes cut for the CPU."""
    files = copy.deepcopy(cell_files(SPEC, workload, ROOT))
    cfg, tr = files["config"], files["traffic"]
    cfg["backbone"]["unet"].update(SMALL_UNET)
    cfg.update(frame=[64, 64, 1], n_nodes=3, max_instances=2)
    if "crop_size" in cfg:
        cfg["crop_size"] = 24
    if "edges" in cfg:
        cfg["edges"] = [[0, 1], [1, 2]]
    tr.update(batch_size=2, trace_start_s=0.2, trace_seconds=0.3)
    if tr["entry"] == "predict":
        tr.update(pool_frames=6, warmup_batches=1, judged_frames=4, judge_block=2)
        files["limits"]["frames_judged"] = {"min": 4}
    if tr["entry"] == "train":
        tr.update(train_frames=6, val_frames=2, warmup_steps=3)
    return files


def tiny_ctx(workload: str, seed: int = 7, seconds: float = 1.0, trace: bool = False):
    files = tiny_files(workload)
    return RunContext(workload=files["workload"], config=files["config"], traffic=files["traffic"],
                      limits=files["limits"], seed=seed, seconds=seconds, trace=trace,
                      device="cpu", chips=1, t_process=time.perf_counter()), files

