"""System / accelerator report.

Port of ``sleap_nn_tpu/system_info.py`` with torch in place of JAX: the
CUDA devices (name, compute capability, memory, driver), a device smoke
test (a matmul on the card, synchronized), the package table with each
package's install provenance (editable / git / local / pip / conda), and a
check that the compilers the port builds with are present (nvcc for the
kernels of ``ops/``, g++ for the grouping library of ``native/``), which
stands where the JAX report checks that jax and jaxlib agree.
"""

from __future__ import annotations

import platform
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, Optional, Tuple

#: Packages reported in ``get_system_info_dict()["packages"]``.
PACKAGES = ("torch", "numpy", "scipy", "opencv-python", "pyyaml")

#: The module each package imports as, where it differs from its name.
_MODULES = {"opencv-python": "cv2", "pyyaml": "yaml"}


def shorten_path(path: str, max_len: int = 50) -> str:
    """Middle-ellipsis long paths for display."""
    s = str(path)
    if len(s) <= max_len:
        return s
    keep = max_len - 3
    head = keep // 2
    return s[:head] + "..." + s[len(s) - (keep - head):]


def get_package_location(name: str) -> Optional[str]:
    """Installed location of a package: the imported module's directory,
    else the distribution metadata's."""
    mod_name = _MODULES.get(name, name.replace("-", "_"))
    try:
        mod = __import__(mod_name)
        f = getattr(mod, "__file__", None)
        if f:
            return str(Path(f).parent)
    except Exception:
        pass
    try:
        from importlib import metadata

        dist = metadata.distribution(name)
        located = getattr(dist, "_path", None)
        if located is not None:
            return str(Path(located).parent)
    except Exception:
        pass
    return None


def _distribution(name: str):
    """The installed distribution of a package; cv2 also ships as
    ``opencv-python-headless`` and ``opencv-contrib-python``."""
    from importlib import metadata

    names = [name]
    if name == "opencv-python":
        names += ["opencv-python-headless", "opencv-contrib-python",
                  "opencv-contrib-python-headless"]
    for n in names:
        try:
            return metadata.distribution(n)
        except metadata.PackageNotFoundError:
            continue
    return None


def get_package_info(name: str) -> Dict:
    """Version, location and install type of one package. ``install_type``
    is ``editable`` / ``git`` / ``local`` / ``conda`` / ``pip`` /
    ``not_installed``, from the distribution's ``direct_url.json`` (PEP
    610) and ``INSTALLER`` records."""
    info: Dict = {"name": name, "version": None, "location": None,
                  "install_type": "not_installed"}
    dist = _distribution(name)
    if dist is None:
        return info
    info["version"] = dist.version
    info["location"] = get_package_location(name)
    info["install_type"] = "pip"
    try:
        import json

        direct = dist.read_text("direct_url.json")
        if direct:
            d = json.loads(direct)
            if d.get("dir_info", {}).get("editable"):
                info["install_type"] = "editable"
            elif "vcs_info" in d:
                info["install_type"] = "git"
                info["vcs_url"] = d.get("url")
            elif d.get("url", "").startswith("file://"):
                info["install_type"] = "local"
    except Exception:
        pass
    try:
        installer = (dist.read_text("INSTALLER") or "").strip()
        if installer == "conda":
            info["install_type"] = "conda"
    except Exception:
        pass
    return info


def _tool_version(cmd) -> Optional[str]:
    """The first line of ``cmd --version`` that names a version, or None
    where the tool is absent."""
    exe = shutil.which(cmd[0]) or (cmd[0] if Path(cmd[0]).is_file() else None)
    if exe is None:
        return None
    try:
        out = subprocess.run([exe, *cmd[1:]], capture_output=True, text=True,
                             timeout=30).stdout
    except Exception:
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    named = [ln for ln in lines if "release" in ln or "version" in ln.lower()]
    return (named or lines or [exe])[0]


def check_build_tools() -> Tuple[Optional[bool], str]:
    """Whether nvcc (the kernels of ``ops/``) and g++ (``native/``'s
    grouping library) are present: True for both, False for neither, None
    for one."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    have = {"nvcc": _tool_version([nvcc, "--version"]),
            "g++": _tool_version(["g++", "--version"])}
    found = [k for k, v in have.items() if v]
    parts = [f"{k}: {v}" if v else f"{k}: not found" for k, v in have.items()]
    ok = True if len(found) == 2 else (None if found else False)
    return ok, "; ".join(parts)


def get_system_info_dict() -> Dict:
    """Collect platform, device and package info."""
    import torch

    info = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "backend": None,
        "devices": [],
        "device_count": 0,
        "driver": None,
    }
    try:
        if torch.cuda.is_available():
            n = torch.cuda.device_count()
            info["backend"] = "cuda"
            info["device_count"] = n
            for i in range(n):
                p = torch.cuda.get_device_properties(i)
                info["devices"].append(
                    f"cuda:{i} {torch.cuda.get_device_name(i)} "
                    f"(sm_{p.major}{p.minor}, {p.total_memory / 2**30:.1f} GiB)")
            info["driver"] = _driver_version()
        else:
            info["backend"] = "cpu"
            info["devices"] = ["cpu"]
            info["device_count"] = 1
    except Exception as e:
        info["error"] = str(e)
    for mod in ("numpy", "scipy"):
        try:
            info[mod] = __import__(mod).__version__
        except Exception:
            info[mod] = None
    info["packages"] = {name: get_package_info(name) for name in PACKAGES}
    ok, msg = check_build_tools()
    info["build_tools_ok"] = ok
    info["build_tools_message"] = msg
    return info


def _driver_version() -> Optional[str]:
    """The NVIDIA driver's version, from ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except Exception:
        return None
    return out.splitlines()[0] if out else None


def test_device_operations(device: Optional[str] = None) -> Dict:
    """Smoke test: a 256x256 matmul on the card (or ``device``),
    synchronized."""
    import time

    import torch

    out = {"ok": False}
    try:
        dev = torch.device(device or ("cuda" if torch.cuda.is_available() else "cpu"))
        x = torch.ones((256, 256), device=dev)
        t0 = time.perf_counter()
        y = x @ x
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        out["ok"] = bool(float(y[0, 0]) == 256.0)
        out["elapsed_s"] = round(time.perf_counter() - t0, 4)
        out["device"] = str(y.device)
    except Exception as e:
        out["error"] = str(e)
    return out


def get_startup_info_string(run_smoke_test: bool = True) -> str:
    """Human-readable startup banner: ``CUDA (N devices)`` or ``CPU
    only``, one row per device and per package."""
    info = get_system_info_dict()
    backend = info["backend"]
    n = info["device_count"]
    if backend == "cuda":
        accel = f"CUDA ({n} device{'s' if n != 1 else ''}, driver {info['driver']})"
    elif backend == "cpu":
        accel = "CPU only"
    else:
        accel = f"{backend} ({n} devices)"
    lines = [
        "sleap-nn-tpu-torch system report",
        f"  python: {info['python']}  torch: {info['torch']} (CUDA {info['cuda']})"
        f"  platform: {info['platform']}",
        f"  accelerator: {accel}",
    ]
    for d in info["devices"]:
        lines.append(f"    - {d}")
    lines.append(f"  {info['build_tools_message']}")
    for name, pkg in info["packages"].items():
        if pkg["version"] is None:
            lines.append(f"  {name}: not installed")
        else:
            loc = shorten_path(pkg["location"] or "?", 40)
            lines.append(
                f"  {name}: {pkg['version']} ({pkg['install_type']}, {loc})"
            )
    if run_smoke_test:
        smoke = test_device_operations()
        lines.append(
            f"  device smoke test: {'OK' if smoke.get('ok') else 'FAILED'} {smoke}"
        )
    return "\n".join(lines)


def print_system_info(run_smoke_test: bool = True) -> None:
    """Print the startup banner."""
    print(get_startup_info_string(run_smoke_test=run_smoke_test))
