"""Native (C++) host code, bound with ctypes: the bottom-up PAF grouping.

Port of ``sleap_nn_tpu/native/__init__.py``. ``paf_group.cpp`` runs one
sample's per-edge Hungarian matching and greedy instance union in one
call; it is the default path of ``PAFScorer.group_sample``, as in the JAX
package. It is host code, not a card kernel.

The library builds at first use with ``g++ -O3 -shared -fPIC -std=c++17``
into ``sleap_nn_tpu_torch/_build/paf_group-<hash>.so``, the hash taken
over the source and the flags, so an edited source is rebuilt and a stale
library never loaded. A build writes a name of its own and renames it
into place, so processes that build at once (the spawn workers of a
grouping pool) never load a half-written library. Where no compiler
builds it, or ``SLEAP_NN_TPU_NO_NATIVE`` is set, callers take the scipy
path, as the JAX package does.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "paf_group.cpp"
BUILD_DIR = SOURCE.parent.parent / "_build"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
build_log = ""


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"paf_group-{h.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> bool:
    """Compile the library unless it exists. Returns success; the compiler's
    output of a failed build is kept in ``build_log``."""
    global build_log
    if lib_path.exists():
        return True
    tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        lib_path.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True, timeout=120)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            return False
        os.replace(tmp, lib_path)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        build_log = str(e)
        return False
    finally:
        tmp.unlink(missing_ok=True)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built on first use; None where it cannot be built
    or loaded, or while ``SLEAP_NN_TPU_NO_NATIVE`` is set."""
    global _lib, _load_failed, build_log
    if os.environ.get("SLEAP_NN_TPU_NO_NATIVE"):
        return None
    if _lib is not None:
        return _lib
    if _load_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        lib_path = library_path()
        if not _build(lib_path):
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(lib_path))
        except OSError as e:
            build_log = str(e)
            _load_failed = True
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.paf_group_sample.restype = ctypes.c_int
        lib.paf_group_sample.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int,          # scores, n_edges, k
            i32p, i32p, ctypes.c_int,                  # edge_src, edge_dst, n_nodes
            i32p, ctypes.c_float, ctypes.c_int,        # order, min_line, min_peaks
            i32p, i32p, i32p, i32p, f32p, i32p,        # outputs
        ]
        _lib = lib
        return _lib


def paf_group_sample_native(
    scores: np.ndarray,
    edge_inds,
    sorted_edge_inds,
    n_nodes: int,
    min_line_scores: float,
    min_instance_peaks: int,
):
    """One sample's dense PAF grouping in C++.

    Args:
        scores: ``(n_edges, K, K)`` float32 with -inf at invalid pairs.

    Returns:
        ``(assign (n_nodes, K) int32 instance ids (-1 none), connections
        {edge: [(src, dst, score), ...]} in the library's order,
        n_instances)``, or None where the library is unavailable (callers
        take the scipy path).
    """
    lib = get_lib()
    if lib is None:
        return None
    scores = np.ascontiguousarray(scores, np.float32)
    n_edges, k = scores.shape[0], scores.shape[1]
    edge_src = np.ascontiguousarray([e[0] for e in edge_inds], np.int32)
    edge_dst = np.ascontiguousarray([e[1] for e in edge_inds], np.int32)
    order = np.ascontiguousarray(sorted_edge_inds, np.int32)

    assign = np.empty((n_nodes, k), np.int32)
    cap = max(1, n_edges * k)
    c_edge = np.empty(cap, np.int32)
    c_src = np.empty(cap, np.int32)
    c_dst = np.empty(cap, np.int32)
    c_score = np.empty(cap, np.float32)
    n_conns = np.zeros(1, np.int32)

    n_inst = lib.paf_group_sample(
        scores.reshape(-1), n_edges, k, edge_src, edge_dst, n_nodes,
        order, float(min_line_scores), int(min_instance_peaks),
        assign.reshape(-1), c_edge, c_src, c_dst, c_score, n_conns,
    )
    nc = int(n_conns[0])
    connections = {}
    # Python scalars in one conversion per array (float32 scores keep their value).
    for e, src, dst, sc in zip(c_edge[:nc].tolist(), c_src[:nc].tolist(),
                               c_dst[:nc].tolist(), c_score[:nc].tolist()):
        connections.setdefault(e, []).append((src, dst, sc))
    return assign, connections, int(n_inst)
