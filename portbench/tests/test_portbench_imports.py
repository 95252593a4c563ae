"""What the benchmark's files import: never JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the plain reference nothing of the port."""

import ast
from pathlib import Path

import pytest

from portbench.core.run import FORBIDDEN, forbidden_modules

PKG = Path(__file__).resolve().parents[1]
FILES = sorted(PKG.rglob("*.py"))


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_anywhere(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert not tops & set(FORBIDDEN), f"{path} imports {tops & set(FORBIDDEN)}"


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    tops = {name.split(".")[0] for name in imported(path)}
    assert "sleap_nn_tpu_torch" not in tops


def test_the_module_check_compares_whole_names():
    assert forbidden_modules(["sleap_nn_tpu_torch", "sleap_nn_tpu_torch.ops", "jaxtyping"]) == []
    assert forbidden_modules(["sleap_nn_tpu.ops", "jax", "flax.linen", "numpy"]) == \
        ["flax.linen", "jax", "sleap_nn_tpu.ops"]


def test_no_file_reads_the_jax_benchmarks():
    for path in FILES:
        text = path.read_text()
        for name in ("bench.py", "BENCH_", "MULTICHIP_", "BASELINE."):
            assert name not in text or path.name.startswith("test_portbench_imports"), (path, name)
