"""CLI tools — one command per reference driver program.

Run as ``python -m bwtb3m <tool> [args...]``. The tool set mirrors
/root/reference/src/Makefile.am:5-34 (29 programs); argument conventions
follow the reference's two styles (ArgInfo ``key=value`` and ArgParser
``-flag``) per tool.
"""

from __future__ import annotations

from typing import Callable, Dict, List

TOOLS: Dict[str, Callable[[List[str]], int]] = {}


def tool(name: str):
    def deco(fn):
        TOOLS[name] = fn
        return fn
    return deco


def load_all() -> None:
    from . import prep, convert, check, ssa_tools, speed, lcp_tools, apps  # noqa: F401
    from ..engine.api import main_bwtb3m

    TOOLS.setdefault("bwtb3m", main_bwtb3m)


def dispatch(argv: List[str]) -> int:
    load_all()
    if not argv or argv[0] in ("-h", "--help", "help"):
        import sys
        sys.stderr.write(
            "usage: python -m bwtb3m <tool> [args...]\ntools:\n  "
            + "\n  ".join(sorted(TOOLS)) + "\n"
        )
        return 1
    name = argv[0]
    if name not in TOOLS:
        import sys
        sys.stderr.write("unknown tool %r; try 'help'\n" % name)
        return 1
    return TOOLS[name](argv[1:]) or 0
