"""CLI `key=@{...}`-style argument parsing.

Counterpart of `robogym_tpu/utils/parse_arguments.py`: CLI positional
arguments of the form `name=value` where value may be a python literal
prefixed with `@` (e.g. `constants=@{"randomize": True}`), plus a trailing
env-name pattern list.
"""

from __future__ import annotations

import ast
from typing import Any, Dict, List, Tuple


def parse_arguments(argv: List[str]) -> Tuple[List[str], Dict[str, Any]]:
    """Split `argv` into names and `name=value` kwargs: (names, kwargs)."""
    names, kwargs = [], {}
    for arg in argv:
        if "=" in arg:
            k, v = arg.split("=", 1)
            kwargs[k] = _parse_value(v)
        else:
            names.append(arg)
    return names, kwargs


def _parse_value(value: str) -> Any:
    """`@`-prefixed python literals, else int/float/bool/str coercion."""
    if value.startswith("@"):
        return ast.literal_eval(value[1:])
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return value
