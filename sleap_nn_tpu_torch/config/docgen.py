"""The config reference, generated from the config dataclasses.

Port of ``sleap_nn_tpu/config/docgen.py``: :func:`generate_config_reference`
walks the port's copy of the schema from ``TrainingJobConfig`` down, one
table a dataclass. Its text is the JAX package's but for the header's
package path. :func:`main` writes only to the path it is given.

    python -m sleap_nn_tpu_torch.config.docgen OUT.md
"""

from __future__ import annotations

import dataclasses
import sys
import typing
from pathlib import Path
from typing import Any, List, Set, Type

HEADER = """# Config reference

Every field of the training-job YAML, generated from the schema
(`sleap_nn_tpu_torch/config/`) — regenerate with
`python -m sleap_nn_tpu_torch.config.docgen OUT.md`. The file layout matches the
reference framework exactly: three top-level sections
(`data_config`, `model_config`, `trainer_config`); unknown keys are
ignored on load, dotted CLI overrides are validated strictly.
"""


def _type_name(tp: Any) -> str:
    """A short readable name of a field's type."""
    origin = typing.get_origin(tp)
    args = typing.get_args(tp)
    if origin is typing.Union:
        non_none = [a for a in args if a is not type(None)]
        inner = ", ".join(_type_name(a) for a in non_none)
        return f"Optional[{inner}]" if len(non_none) < len(args) else inner
    if origin is list:
        return f"list[{_type_name(args[0])}]" if args else "list"
    if origin is tuple:
        return "tuple"
    if origin is dict:
        return "dict"
    if dataclasses.is_dataclass(tp):
        return f"[{tp.__name__}](#{tp.__name__.lower()})"
    return getattr(tp, "__name__", str(tp).replace("typing.", ""))


def _default_repr(f: dataclasses.Field) -> str:
    if f.default is not dataclasses.MISSING:
        return f"`{f.default!r}`"
    if f.default_factory is not dataclasses.MISSING:
        value = f.default_factory()
        if dataclasses.is_dataclass(value):
            return f"[{type(value).__name__}](#{type(value).__name__.lower()}) defaults"
        return f"`{value!r}`"
    return "**required**"


def _walk(cls: Type, seen: Set[Type], out: List[str], level: int) -> None:
    if cls in seen:
        return
    seen.add(cls)
    doc = (cls.__doc__ or "").strip().splitlines()
    out.append(f"{'#' * min(level, 5)} {cls.__name__}\n")
    if doc and doc[0]:
        out.append(doc[0] + "\n")
    out.append("| field | type | default |")
    out.append("|---|---|---|")
    hints = typing.get_type_hints(cls)
    children: List[Type] = []
    for f in dataclasses.fields(cls):
        tp = hints.get(f.name, f.type)
        out.append(f"| `{f.name}` | {_type_name(tp)} | {_default_repr(f)} |")
        stack = [tp]  # nested dataclasses, Optional[...] ones too
        while stack:
            t = stack.pop()
            if dataclasses.is_dataclass(t):
                children.append(t)
            else:
                stack.extend(typing.get_args(t))
    out.append("")
    for child in children:
        _walk(child, seen, out, level + 1)


def generate_config_reference() -> str:
    """The config reference as Markdown."""
    from sleap_nn_tpu_torch.config import TrainingJobConfig

    out: List[str] = [HEADER]
    _walk(TrainingJobConfig, set(), out, 2)
    return "\n".join(out).rstrip() + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 1:
        print("usage: python -m sleap_nn_tpu_torch.config.docgen OUT.md", file=sys.stderr)
        return 2
    target = Path(argv[0])
    target.write_text(generate_config_reference())
    print(f"Wrote {target}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
