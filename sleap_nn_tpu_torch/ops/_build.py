"""Build the port's CUDA kernels with nvcc at first use and load them with ctypes.

Each kernel source in ``csrc/`` compiles on its own into a shared library
with a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o _build/<stem>-<hash>.so csrc/<stem>.cu

The library name carries a hash of the source, the shared headers and the
flags, so an edited source is rebuilt and a stale one never loaded. Builds
of several kernels run in parallel (one nvcc each). ``Kernel.launch``
calls the C entry, whose ``cudaError_t`` result is checked, and counts
the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# Every kernel of the port, by name (filled as the ops modules import).
KERNELS: Dict[str, "Kernel"] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")
    return path


def _digest(source: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source] + sorted(CSRC.glob("*.cuh")):
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


class Kernel:
    """One CUDA kernel: source, C entry point, ctypes signature, launch count.

    ``launches`` counts successful launches made through :meth:`launch`;
    callers reset it to 0 to count one run.
    """

    def __init__(self, name: str, source: str, argtypes: List[type]):
        self.name = name
        self.source = CSRC / source
        self.argtypes = argtypes
        self.launches = 0
        self.build_log = ""
        self._lib = None
        KERNELS[name] = self

    @property
    def library(self) -> Path:
        return BUILD_DIR / f"{self.source.stem}-{_digest(self.source)}.so"

    def load(self):
        """Build the kernel if needed and bind its C entry point."""
        if self._lib is None:
            build([self])
            lib = ctypes.CDLL(str(self.library))
            getattr(lib, self.name).argtypes = self.argtypes
            getattr(lib, self.name).restype = ctypes.c_int
            getattr(lib, f"{self.name}_error_string").argtypes = [ctypes.c_int]
            getattr(lib, f"{self.name}_error_string").restype = ctypes.c_char_p
            self._lib = lib
        return self._lib

    def launch(self, *args) -> None:
        """Launch on the caller's stream; raise on a CUDA error, else count it."""
        lib = self.load()
        err = getattr(lib, self.name)(*args)
        if err != 0:
            msg = getattr(lib, f"{self.name}_error_string")(err).decode()
            raise RuntimeError(f"{self.name}: CUDA error {err}: {msg}")
        self.launches += 1


def build(kernels: Optional[Iterable[Kernel]] = None) -> float:
    """Compile every kernel whose library is missing, in parallel.

    Returns the seconds spent; raises with nvcc's output on a failure.
    """
    kernels = list(KERNELS.values()) if kernels is None else list(kernels)
    todo = [k for k in kernels if not k.library.exists()]
    if not todo:
        return 0.0
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for k in todo:
        tmp = k.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(k.source)]
        procs.append((k, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for k, tmp, proc in procs:
        k.build_log = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, k.library)
        else:
            failed.append(f"{k.source.name} (nvcc exit {proc.returncode}):\n{k.build_log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0
