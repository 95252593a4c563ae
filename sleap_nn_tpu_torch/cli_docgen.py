"""The command-line reference, generated from the command table itself.

Port of ``sleap_nn_tpu/cli_docgen.py``: where the JAX package reads its
click declarations, this reads the port's argparse table
(``cli.COMMANDS``: each command's ``Arg`` and ``Opt`` entries), in the same
Markdown layout. :func:`main` writes only to the path it is given.

    python -m sleap_nn_tpu_torch.cli_docgen OUT.md
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import List

HEADER = """# CLI reference

Every command and flag of `sleap-nn-tpu-torch`, generated from the argparse
declarations (`sleap_nn_tpu_torch/cli.py`) — regenerate with
`python -m sleap_nn_tpu_torch.cli_docgen OUT.md`. Flags accept both dashed and
underscored spellings (`--peak-threshold` / `--peak_threshold`), matching
the reference CLI. Hidden aliases (e.g. `infer`) are included and marked.
"""

# Click's names of the parameter types the table declares.
_TYPE_NAMES = {int: "integer", float: "float", str: "text"}


def _fmt_default(opt) -> str:
    if opt.required:
        return "**required**"
    if opt.is_flag:
        return "`True`" if opt.default else "`False`"
    if opt.default is None or (opt.multiple and not opt.default):
        return "—"
    return f"`{opt.default!r}`"


def _fmt_type(opt) -> str:
    if opt.is_flag:
        return "flag"
    if opt.choices is not None:
        name = "choice"
    elif opt.exists:
        name = "path"
    else:
        name = getattr(opt.type, "param_name", None) or _TYPE_NAMES.get(opt.type, "text")
    if opt.multiple:
        name += ", repeatable"
    return name


def _dedupe_spellings(opts: List[str]) -> str:
    """One flag for each dashed / underscored pair of spellings."""
    canon, seen = [], set()
    for o in opts:
        key = o.replace("_", "-")
        if key not in seen:
            seen.add(key)
            canon.append(key)
    return ", ".join(f"`{c}`" for c in canon)


def generate_cli_reference() -> str:
    """The command-line reference as Markdown, commands in name order."""
    from sleap_nn_tpu_torch.cli import COMMANDS, Arg, Opt

    out: List[str] = [HEADER]
    for name in sorted(COMMANDS):
        cmd = COMMANDS[name]
        out.append(f"## `{name}`{' *(hidden alias)*' if cmd.hidden else ''}\n")
        help_text = cmd.help.strip().splitlines()
        if help_text:
            out.append(help_text[0] + "\n")
        args = [p for p in cmd.params if isinstance(p, Arg)]
        if args:
            out.append("Arguments: " + ", ".join(f"`{a.name.upper()}`" for a in args) + "\n")
        opts = [p for p in cmd.params if isinstance(p, Opt)]
        if opts:
            out.append("| option | type | default | help |")
            out.append("|---|---|---|---|")
            for opt in opts:
                if opt.hidden:
                    continue
                flags = _dedupe_spellings(opt.opts + opt.secondary_opts)
                hlp = opt.help.replace("|", "\\|").replace("\n", " ")
                out.append(f"| {flags} | {_fmt_type(opt)} | {_fmt_default(opt)} | {hlp} |")
            out.append("")
    return "\n".join(out).rstrip() + "\n"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 1:
        print("usage: python -m sleap_nn_tpu_torch.cli_docgen OUT.md", file=sys.stderr)
        return 2
    target = Path(argv[0])
    target.write_text(generate_cli_reference())
    print(f"Wrote {target}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
