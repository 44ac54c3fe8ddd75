"""Env loading from a config: the part of `robogym_tpu/utils/env_utils.py`
that the holdout envs need.

`load_env(path, constants=..., parameters=...)` evaluates a `.jsonnet`
config, resolves its `make_env` entry (`{"function":
"module:fn", "args": {...}}`) with `get_function`, merges the caller's
`constants` / `parameters` into the config's, and calls the factory.
Module paths under `robogym.` (robogym's own configs) resolve under
`robogym_torch.`.
"""

from __future__ import annotations

import functools
import importlib
import inspect
from typing import Any, Callable, Dict, Optional

from robogym_torch.utils import jsonnet


def get_function(fn_data: Dict[str, Any]) -> Callable:
    """The callable of a `{"function": "module:fn", "args": {...}}`
    reference, its args bound by `functools.partial`."""
    module_path, fn_name = fn_data["function"].split(":")
    if module_path.startswith("robogym."):
        module_path = "robogym_torch." + module_path[len("robogym."):]
    fn = getattr(importlib.import_module(module_path), fn_name)
    extra_args = fn_data.get("args", {})
    return functools.partial(fn, **extra_args) if extra_args else fn


def _recursive_update(base: dict, update: dict) -> dict:
    out = dict(base)
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _recursive_update(out[k], v)
        else:
            out[k] = v
    return out


def load_env(path: str, constants: Optional[dict] = None, parameters: Optional[dict] = None,
             **kwargs):
    """The env of the config at `path`: its `make_env` factory called with
    the config's constants and parameters, the caller's `constants` /
    `parameters` merged into them recursively, and those of `kwargs` the
    factory takes (`device`, `seed`, `worlds`, ...)."""
    make_env = get_function(jsonnet.evaluate_file(path)["make_env"])
    bound = make_env.keywords if isinstance(make_env, functools.partial) else {}
    call_kwargs = {}
    if constants is not None:
        call_kwargs["constants"] = _recursive_update(bound.get("constants", {}) or {}, constants)
    if parameters is not None:
        call_kwargs["parameters"] = _recursive_update(bound.get("parameters", {}) or {},
                                                      parameters)
    sig = inspect.signature(make_env)
    call_kwargs.update({k: v for k, v in kwargs.items() if k in sig.parameters})
    return make_env(**call_kwargs)
