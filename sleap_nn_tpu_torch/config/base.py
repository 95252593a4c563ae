"""Dataclass <-> dict/YAML conversion helpers for the config system.

Port of ``sleap_nn_tpu/config/base.py``: recursive ``from_dict`` /
``to_dict``, YAML round-trip and dotted-path overrides (``a.b.c=value``).
PyYAML is imported only by the functions that read or write YAML, so the
configs work on a machine without it.
"""

from __future__ import annotations

import dataclasses
import re
import typing
from typing import Any, Dict, Optional, Type, Union


def _resolve_type(tp):
    """Unwrap Optional[...] to its inner type; return (inner, is_optional)."""
    origin = typing.get_origin(tp)
    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
        return None, True
    return tp, False


def from_dict(cls: Type, data: Any):
    """Recursively build a dataclass from a plain dict (unknown keys ignored)."""
    if data is None:
        return None
    if not dataclasses.is_dataclass(cls):
        return data
    if dataclasses.is_dataclass(type(data)):
        return data
    if not isinstance(data, dict):
        return data
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in data:
            continue
        val = data[f.name]
        inner, _ = _resolve_type(hints.get(f.name, Any))
        if inner is not None and dataclasses.is_dataclass(inner):
            kwargs[f.name] = from_dict(inner, val)
        else:
            kwargs[f.name] = _coerce_scalar(inner, val)
    return cls(**kwargs)


def _coerce_scalar(inner: Optional[Type], val: Any) -> Any:
    """Coerce a YAML scalar onto the field's annotated numeric type.

    YAML 1.1 resolves ``1e-06`` (no '.') to a string; numbers that arrive as
    strings or floats are normalized onto the annotated type. Anything that
    does not parse is returned untouched.
    """
    if val is None:
        return val
    if inner is None or inner is Any:
        if isinstance(val, str) and re.fullmatch(
                r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", val.strip()):
            try:
                f = float(val)
                return int(f) if f.is_integer() and ("e" not in val.lower()
                                                     and "." not in val) else f
            except ValueError:
                return val
        return val
    try:
        if inner is float and isinstance(val, (str, int)):
            return float(val)
        if inner is int and isinstance(val, (str, float)) and float(val) == int(float(val)):
            return int(float(val))
        if inner is bool and isinstance(val, str):
            if val.lower() in ("true", "1", "yes"):
                return True
            if val.lower() in ("false", "0", "no"):
                return False
    except (TypeError, ValueError):
        return val
    return val


def to_dict(obj: Any) -> Any:
    """Recursively convert dataclasses to plain dicts (yaml-serializable)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: to_dict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {k: to_dict(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    return obj


def to_yaml(obj: Any) -> str:
    import yaml

    return yaml.safe_dump(to_dict(obj), sort_keys=False)


def save_yaml(obj: Any, path):
    with open(path, "w") as f:
        f.write(to_yaml(obj))


def load_yaml(cls: Type, path):
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f)
    return from_dict(cls, data)


def apply_overrides(obj: Any, overrides: Dict[str, Any]):
    """Apply dotted-path overrides in place: ``{"a.b.c": 1}``.

    Intermediate ``None`` nodes are instantiated with their field's default
    dataclass type. A string value is parsed as YAML (PyYAML is imported
    only then).
    """
    for path, value in overrides.items():
        parts = path.split(".")
        node = obj
        for part in parts[:-1]:
            if dataclasses.is_dataclass(node) and part not in {
                f.name for f in dataclasses.fields(node)
            }:
                raise AttributeError(
                    f"Unknown config field '{part}' in override '{path}'."
                )
            child = getattr(node, part)
            if child is None:
                hints = typing.get_type_hints(type(node))
                inner, _ = _resolve_type(hints[part])
                if inner is not None and dataclasses.is_dataclass(inner):
                    child = inner()
                    setattr(node, part, child)
                else:
                    raise ValueError(f"Cannot descend into null non-dataclass field: {part}")
            node = child
        leaf = parts[-1]
        if dataclasses.is_dataclass(node) and leaf not in {
            f.name for f in dataclasses.fields(node)
        }:
            raise AttributeError(f"Unknown config field '{leaf}' in override '{path}'.")
        if isinstance(value, str):
            import yaml

            value = yaml.safe_load(value)
        if dataclasses.is_dataclass(node):
            hints = typing.get_type_hints(type(node))
            inner, _ = _resolve_type(hints.get(leaf, Any))
            if inner is not None and not dataclasses.is_dataclass(inner):
                value = _coerce_scalar(inner, value)
        setattr(node, leaf, value)
    return obj
