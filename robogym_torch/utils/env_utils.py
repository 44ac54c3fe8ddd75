"""Env resolution and loading.

Counterpart of `robogym_tpu/utils/env_utils.py` (robogym's
utils/env_utils.py): `MakeEnvFinder.find` resolves an env factory from a
`.py` file path, a `.json` or `.jsonnet` config (`{"make_env": {"function":
"module:fn", "args": {...}}}`, resolved by `get_function`), or a name
fragment matched against the port's env zoo (`robogym_torch/envs/`);
`load_env(pattern, constants=..., parameters=...)` calls the factory it
finds, the caller's `constants` / `parameters` merged into the config's.
Module paths under `robogym.` (robogym's own configs) resolve under
`robogym_torch.`.
"""

from __future__ import annotations

import functools
import glob
import importlib
import inspect
import json
import os
import runpy
from typing import Any, Callable, Dict, Optional

from robogym_torch.utils import jsonnet

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENVS_ROOT = os.path.join(PACKAGE_ROOT, "envs")


class InvalidSimulationError(Exception):
    """(env_utils.py:13-16): unrecoverable invalid simulation state."""


def get_function(fn_data: Dict[str, Any]) -> Callable:
    """The callable of a `{"function": "module:fn", "args": {...}}`
    reference, its args bound by `functools.partial`."""
    module_path, fn_name = fn_data["function"].split(":")
    if module_path.startswith("robogym."):
        module_path = "robogym_torch." + module_path[len("robogym."):]
    fn = getattr(importlib.import_module(module_path), fn_name)
    extra_args = fn_data.get("args", {})
    return functools.partial(fn, **extra_args) if extra_args else fn


def gym_space_from_arrays(arrays):
    """The observation space of an observation tree (env_utils.py:17-28):
    {key: shape}; the port has no gym dependency, so shapes serve the same
    introspection."""
    if isinstance(arrays, dict):
        return {k: gym_space_from_arrays(v) for k, v in arrays.items()}
    return tuple(getattr(arrays, "shape", ()))


def _module_attr(path: str, name: str):
    """Attribute `name` of the Python file `path`: imported as its module
    where the file is in this package, run with `runpy` elsewhere."""
    path = os.path.abspath(path)
    if path.startswith(PACKAGE_ROOT + os.sep):
        rel = os.path.relpath(path, os.path.dirname(PACKAGE_ROOT))
        return getattr(importlib.import_module(rel[:-3].replace(os.sep, ".")), name, None)
    return runpy.run_path(path).get(name)


class MakeEnvFinder:
    """(env_utils.py:64-134)."""

    @classmethod
    def find(cls, pattern: str, arg_filter: Optional[str] = "make_env"):
        """The env factory `pattern` names, or None."""
        name = arg_filter or "make_env"
        if pattern.endswith(".py") and os.path.exists(pattern):
            return _module_attr(pattern, name)
        if pattern.endswith(".json") and os.path.exists(pattern):
            with open(pattern) as f:
                return get_function(json.load(f)["make_env"])
        if pattern.endswith((".jsonnet", ".libsonnet")) and os.path.exists(pattern):
            return get_function(jsonnet.evaluate_file(pattern)["make_env"])
        matches = [path for path in sorted(glob.glob(os.path.join(ENVS_ROOT, "**", "*.py"),
                                                     recursive=True))
                   if pattern in os.path.relpath(path, ENVS_ROOT)
                   and not os.path.basename(path).startswith("_")]
        return _module_attr(matches[0], name) if matches else None


def _recursive_update(base: dict, update: dict) -> dict:
    out = dict(base)
    for k, v in update.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _recursive_update(out[k], v)
        else:
            out[k] = v
    return out


def load_env(pattern: str, constants: Optional[dict] = None, parameters: Optional[dict] = None,
             **kwargs):
    """The env that `MakeEnvFinder.find(pattern)` names: its factory called
    with the caller's `constants` / `parameters` merged recursively into
    those a config binds, and those of `kwargs` the factory takes
    (`device`, `seed`, `worlds`, ...)."""
    make_env = MakeEnvFinder.find(pattern)
    if make_env is None:
        raise ValueError(f"no env found for pattern {pattern!r}")
    bound = make_env.keywords if isinstance(make_env, functools.partial) else {}
    call_kwargs = {}
    if constants is not None:
        call_kwargs["constants"] = _recursive_update(bound.get("constants", {}) or {}, constants)
    if parameters is not None:
        call_kwargs["parameters"] = _recursive_update(bound.get("parameters", {}) or {},
                                                      parameters)
    sig = inspect.signature(make_env)
    call_kwargs.update({k: v for k, v in kwargs.items() if k in sig.parameters})
    if "parameters" in call_kwargs and "parameters" not in sig.parameters:
        del call_kwargs["parameters"]
    return make_env(**call_kwargs)
