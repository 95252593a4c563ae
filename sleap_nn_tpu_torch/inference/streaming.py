"""Host grouping of bottom-up batches, inline or in a process pool.

Port of ``sleap_nn_tpu/inference/streaming.py``. The device produces dense
per-edge line scores; turning them into instances (per-edge Hungarian +
greedy union) is sequential CPU work. With ``paf_workers > 0`` the
predictor runs it in a spawn-context process pool, overlapped with the
device work of later batches; results come back in submission order.

The payloads crossing the process boundary are the small fetched numpy
arrays (grouped peak candidates + scores), never device tensors; each
worker gets the :class:`~sleap_nn_tpu_torch.inference.paf_grouping.PAFScorer`
once, through the pool initializer.
"""

from __future__ import annotations

from concurrent.futures import Future, ProcessPoolExecutor
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

# Per-worker state installed by the pool initializer.
_SCORER = None
_MAX_INSTANCES = None
_RETURN_PAF_GRAPH = False


def group_batch_host(payload: Dict, scorer, max_instances: Optional[int],
                     return_paf_graph: bool = False) -> Dict:
    """Group one fetched batch into instances (the host half of bottom-up).

    ``payload`` carries numpy ``grouped_peaks``/``grouped_vals``/``scores``
    plus the scalar ``lift`` back to original-image coordinates.

    ``return_paf_graph`` adds the per-sample matched candidate graph
    (peaks, edge_inds, edge_peak_inds, line_scores) under ``pred_paf_graph``.
    """
    gp, gv, sc = payload["grouped_peaks"], payload["grouped_vals"], payload["scores"]
    lift = float(payload["lift"])
    pred_instances, pred_vals, inst_scores = [], [], []
    paf_graphs = [] if return_paf_graph else None
    for i in range(gp.shape[0]):
        if return_paf_graph:
            pts, vals, scores, matches = scorer.group_sample(
                gp[i], gv[i], sc[i], return_matches=True
            )
            paf_graphs.append((
                np.asarray(gp[i]) * lift,
                np.asarray([m[0] for m in matches], np.int32),
                np.asarray([[m[1], m[2]] for m in matches], np.int32).reshape(-1, 2),
                np.asarray([m[3] for m in matches], np.float32),
            ))
        else:
            pts, vals, scores = scorer.group_sample(gp[i], gv[i], sc[i])
        if max_instances is not None and pts.shape[0] > max_instances:
            order = np.argsort(-scores)[:max_instances]
            pts, vals, scores = pts[order], vals[order], scores[order]
        pred_instances.append(pts * lift)
        pred_vals.append(vals)
        inst_scores.append(scores)
    out = {
        "pred_keypoints": pred_instances,
        "pred_peak_values": pred_vals,
        "pred_instance_scores": inst_scores,
    }
    if return_paf_graph:
        out["pred_paf_graph"] = paf_graphs
    # return_confmaps: the layer emitted confmaps/pafs; pass them through.
    for k in ("confmaps", "pafs"):
        if k in payload:
            out[k] = payload[k]
    return out


def _init_worker(scorer, max_instances, return_paf_graph=False) -> None:
    global _SCORER, _MAX_INSTANCES, _RETURN_PAF_GRAPH
    _SCORER = scorer
    _MAX_INSTANCES = max_instances
    _RETURN_PAF_GRAPH = return_paf_graph


def _group_in_worker(payload: Dict) -> Dict:
    return group_batch_host(payload, _SCORER, _MAX_INSTANCES,
                            return_paf_graph=_RETURN_PAF_GRAPH)


class PafGroupingPool:
    """Spawn-context process pool for PAF grouping (context manager).

    ``spawn``, never ``fork``: a forked child would inherit the parent's
    CUDA context and threads. Workers pay a one-time interpreter + import
    start, amortized over the video.

    Args:
        n_workers: Worker process count (>= 1; the caller takes the inline
            path for 0).
        scorer: A picklable ``PAFScorer`` shipped once per worker.
        max_instances: Optional per-frame instance cap applied in-worker.
    """

    def __init__(self, n_workers: int, scorer, max_instances: Optional[int] = None,
                 return_paf_graph: bool = False):
        if n_workers < 1:
            raise ValueError(
                f"n_workers must be >= 1, got {n_workers}; use the inline "
                "path (paf_workers=0) for single-process grouping."
            )
        self.n_workers = n_workers
        self.scorer = scorer
        self.max_instances = max_instances
        self.return_paf_graph = return_paf_graph
        self._executor: Optional[ProcessPoolExecutor] = None
        self._pending: List[Tuple[int, Future]] = []

    def __enter__(self) -> "PafGroupingPool":
        import multiprocessing

        self._executor = ProcessPoolExecutor(
            max_workers=self.n_workers,
            mp_context=multiprocessing.get_context("spawn"),
            initializer=_init_worker,
            initargs=(self.scorer, self.max_instances, self.return_paf_graph),
        )
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._executor is not None:
            self._executor.shutdown(wait=True, cancel_futures=exc is not None)
            self._executor = None

    def submit(self, ordinal: int, payload: Dict) -> None:
        """Enqueue one fetched batch payload; ``ordinal`` orders the drain."""
        if self._executor is None:
            raise RuntimeError(
                "PafGroupingPool.submit outside the `with` block; the pool has no workers.")
        self._pending.append((ordinal, self._executor.submit(_group_in_worker, payload)))

    def drain_one(self) -> Optional[Tuple[int, Dict]]:
        """Pop + block on the OLDEST pending batch (FIFO); None when empty."""
        if not self._pending:
            return None
        ordinal, future = self._pending.pop(0)
        return ordinal, future.result()

    def iter_completed(self) -> Iterator[Tuple[int, Dict]]:
        """Drain everything, yielding ``(ordinal, grouped)`` in submission order."""
        while self._pending:
            yield self.drain_one()

    def __len__(self) -> int:
        return len(self._pending)
