"""Re-exports imported on first use, for the subpackages whose modules
import torch: importing the subpackage itself then imports no torch."""

import importlib
import sys


def reexports(package: str, sources: dict):
    """``(__all__, __getattr__, __dir__)`` for ``package``, re-exporting the
    names of ``sources`` (``{submodule: names}``) from their submodules."""
    module_of = {name: mod for mod, names in sources.items() for name in names}

    def __getattr__(name: str):
        if name in module_of:
            return getattr(importlib.import_module(f"{package}.{module_of[name]}"), name)
        raise AttributeError(f"module {package!r} has no attribute {name!r}")

    def __dir__():
        return sorted(set(vars(sys.modules[package])) | set(module_of))

    return sorted(module_of), __getattr__, __dir__
