"""Port parity: the subpackages' public names (``config``, ``io``, ``ops``,
``models``, ``data``) against the JAX package's.

Each JAX subpackage's ``__init__`` is read with ``ast`` (no JAX import):
every name in its ``__all__`` and every name it imports is an attribute of
the port's subpackage, less the names the port does not copy, and is the
object of the port module that mirrors the JAX module it comes from. The
JAX tests' ``from sleap_nn_tpu.<subpackage> import ...`` lines run against
the port with the package name swapped. ``ops``, ``models`` and ``data``
import their names on first use, so importing the five imports no torch.
"""

import ast
import importlib
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PACKAGES = ("config", "io", "ops", "models", "data")
# JAX names the port does not copy (ROADMAP.md's no-copy list).
NO_COPY = {"OffsetRefinementHead"}


def _jax_init(sub):
    """``(__all__, {name: source module})`` of ``sleap_nn_tpu/<sub>/__init__.py``."""
    tree = ast.parse((ROOT / "sleap_nn_tpu" / sub / "__init__.py").read_text())
    names, sources = [], {}
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and node.module.startswith("sleap_nn_tpu."):
            sources.update({a.asname or a.name: node.module for a in node.names})
        elif isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
            names = ast.literal_eval(node.value)
    return names, sources


def _port(module):
    return importlib.import_module(module.replace("sleap_nn_tpu.", "sleap_nn_tpu_torch.", 1))


@pytest.mark.parametrize("sub", PACKAGES)
def test_every_jax_name_is_the_port_modules_own_object(sub):
    jax_all, sources = _jax_init(sub)
    pkg = importlib.import_module(f"sleap_nn_tpu_torch.{sub}")
    assert set(pkg.__all__) >= set(jax_all) - NO_COPY
    assert set(sources) - NO_COPY <= set(dir(pkg))
    for name, module in sources.items():
        if name not in NO_COPY:
            assert getattr(pkg, name) is getattr(_port(module), name), f"{sub}.{name}"
    for name in pkg.__all__:  # the port's own additions resolve too
        assert getattr(pkg, name) is not None


@pytest.mark.parametrize("sub", PACKAGES)
def test_an_unknown_name_raises_attribute_error(sub):
    pkg = importlib.import_module(f"sleap_nn_tpu_torch.{sub}")
    with pytest.raises(AttributeError, match=f"sleap_nn_tpu_torch.{sub}"):
        getattr(pkg, "no_such_name")
    with pytest.raises(ImportError):
        exec(f"from sleap_nn_tpu_torch.{sub} import no_such_name", {})


def test_the_subpackages_import_no_torch_until_a_name_is_used():
    code = (
        "import sys\n"
        "import sleap_nn_tpu_torch.config, sleap_nn_tpu_torch.io, sleap_nn_tpu_torch.ops, "
        "sleap_nn_tpu_torch.models, sleap_nn_tpu_torch.data\n"
        "assert 'torch' not in sys.modules and 'jax' not in sys.modules, sorted(sys.modules)\n"
        "assert 'crop_bboxes' in dir(sleap_nn_tpu_torch.ops)\n"
        "from sleap_nn_tpu_torch.ops import crop_bboxes\n"
        "from sleap_nn_tpu_torch.ops.crops import crop_bboxes as defined\n"
        "assert crop_bboxes is defined and 'torch' in sys.modules\n"
        "assert 'jax' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def _jax_test_imports():
    """``{test file: [from-import statements of the five subpackages]}`` of
    the JAX package's tests."""
    modules = {f"sleap_nn_tpu.{sub}" for sub in PACKAGES}
    found = {}
    for path in sorted((ROOT / "tests").rglob("test_*.py")):
        if path.name.startswith("test_torch_"):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom) and node.module in modules:
                found.setdefault(str(path.relative_to(ROOT)), []).append(node)
    return found


JAX_TEST_IMPORTS = _jax_test_imports()


@pytest.mark.parametrize("test_file", sorted(JAX_TEST_IMPORTS))
def test_jax_tests_import_lines_work_against_the_port(test_file):
    for node in JAX_TEST_IMPORTS[test_file]:
        names = [a for a in node.names if a.name not in NO_COPY]
        stmt = ast.ImportFrom(module=node.module.replace("sleap_nn_tpu.", "sleap_nn_tpu_torch.",
                                                         1), names=names, level=0)
        namespace = {}
        exec(compile(ast.fix_missing_locations(ast.Module([stmt], [])), test_file, "exec"),
             namespace)
        for a in names:
            assert namespace[a.asname or a.name] is getattr(_port(node.module), a.name)
