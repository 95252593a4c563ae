"""The port stands alone: it imports without JAX and names nothing of the
JAX package (nor does chip_smoke.py). It never imports networkx or orbax
(which imports JAX; ``tools/orbax_to_torch.py`` converts a JAX trainer's
checkpoints), and imports PyYAML and h5py only inside the functions that
read or write YAML or ``.slp`` files, and cv2 only inside the flow-shift
tracker's optical flow: the GPU machine has neither h5py nor cv2."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "sleap_nn_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "sleap_nn_tpu", "networkx")
# Blocked while importing every port module; only a function body may import it.
LAZY = ("yaml", "h5py", "cv2")


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _imported_roots(path: Path, outside_functions: bool = False):
    """The modules ``path`` imports; with ``outside_functions``, only those
    imported outside every function body (at import time)."""
    tree = ast.parse(path.read_text(), str(path))
    if outside_functions:
        for fn in [n for n in ast.walk(tree)
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            fn.body = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_every_port_module_imports_with_jax_blocked():
    mods = list(_port_modules())
    assert {"sleap_nn_tpu_torch.inference.predictor",
            "sleap_nn_tpu_torch.inference.paf_grouping",
            "sleap_nn_tpu_torch.io.model",
            "sleap_nn_tpu_torch.config.training_job_config",
            "sleap_nn_tpu_torch.data.augmentation",
            "sleap_nn_tpu_torch.data.pipeline",
            "sleap_nn_tpu_torch.data.instance_cropping",
            "sleap_nn_tpu_torch.ops.confmaps",
            "sleap_nn_tpu_torch.ops.edge_maps",
            "sleap_nn_tpu_torch.training.model_trainer",
            "sleap_nn_tpu_torch.train",
            "sleap_nn_tpu_torch.inference.loaders",
            "sleap_nn_tpu_torch.inference.filters",
            "sleap_nn_tpu_torch.inference.provenance",
            "sleap_nn_tpu_torch.inference.writer",
            "sleap_nn_tpu_torch.inference.run",
            "sleap_nn_tpu_torch.io.png",
            "sleap_nn_tpu_torch.io.slp",
            "sleap_nn_tpu_torch.io.video",
            "sleap_nn_tpu_torch.evaluation",
            "sleap_nn_tpu_torch.tracking",
            "sleap_nn_tpu_torch.tracking.candidates",
            "sleap_nn_tpu_torch.tracking.kalman",
            "sleap_nn_tpu_torch.tracking.tracker",
            "sleap_nn_tpu_torch.tracking.utils",
            "sleap_nn_tpu_torch.training.callbacks",
            "sleap_nn_tpu_torch.inference.identity",
            "sleap_nn_tpu_torch.data.identity"} <= set(mods)
    code = (
        "import sys\n"
        "for name in %r: sys.modules[name] = None\n"
        "import importlib\n"
        "for m in %r: importlib.import_module(m)\n"
        "print('ok')\n" % (FORBIDDEN + LAZY, mods)
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    bad = [m for m in _imported_roots(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"
    eager = [m for m in _imported_roots(path, outside_functions=True)
             if m.split(".")[0] in LAZY]
    assert not eager, f"{path.name} imports {eager} outside a function"
