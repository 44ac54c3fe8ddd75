"""Per-reset parameter -> Model mutators (the modifier registry).

Counterpart of `robogym_tpu/mjcf/modifiers.py` (robogym's
mujoco/modifiers, registered per parameter name by
`RobotEnv.register_modifier` and applied each reset as
`modifier(getattr(self.parameters, param_name))`).

A Modifier is a pure function `(Model, value) -> Model` through
`Model.replace`. A value shared by the batch rebuilds a shared field; a
value with a leading env axis `(B, ...)` (each env's own, as the JAX
package's vmapped reset gives it) makes the field each env's own, riding
the model's `env_fields` as the sim randomizers' fields do
(`envs.core.apply_model_fields`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from robogym_torch.mjcf.model import Model


def _per_env(model: Model, fields: Dict[str, torch.Tensor]) -> Model:
    from robogym_torch.envs import core

    return core.apply_model_fields(model, fields)


class Modifier:
    """Base parameter modifier: maps a parameter value onto a new Model."""

    def __call__(self, model: Model, value) -> Model:
        raise NotImplementedError


class TimestepModifier(Modifier):
    """Set `opt.timestep` (modifiers/timestep.py:4-8); a (B,) value sets
    each env's own."""

    def __call__(self, model: Model, timestep) -> Model:
        old = model.opt.timestep
        ts = torch.as_tensor(timestep, dtype=old.dtype, device=old.device)
        if ts.dim() > old.dim():
            return _per_env(model, {"opt:timestep": ts})
        return model.replace(opt=dataclasses.replace(model.opt, timestep=ts))


class FieldRowsModifier(Modifier):
    """Scale or set rows of one Model field for named elements.

    The general analogue of the reference's ad-hoc modifiers (e.g. the
    cube-size modifiers in envs/dactyl/common/mujoco_modifiers.py): resolve
    element names to ids once, on the first call, then apply a value.

    mode: "set" writes the value into the selected rows, "scale" multiplies
    them by it. A value with more dims than the selected rows of one env is
    each env's own, its first axis the env's: the field becomes per-env,
    `(B, ...)`.
    """

    def __init__(self, field: str, kind: str, names: Sequence[str], mode: str = "scale"):
        if mode not in ("set", "scale"):
            raise ValueError(f"mode {mode!r}: want 'set' or 'scale'")
        self.field = field
        self.kind = kind
        self.element_names = tuple(names)
        self.mode = mode
        self._ids = None

    def _resolve(self, model: Model) -> np.ndarray:
        if self._ids is None:
            table = model.const.names[self.kind]
            self._ids = np.asarray([table[n] for n in self.element_names], np.int64)
        return self._ids

    def __call__(self, model: Model, value) -> Model:
        arr = getattr(model, self.field)
        ids = torch.as_tensor(self._resolve(model), device=arr.device)
        v = torch.as_tensor(value, dtype=arr.dtype, device=arr.device)
        shared = not model.per_env(self.field)
        row_dim = arr.dim() - (0 if shared else 1)
        if shared and v.dim() <= row_dim:
            new = arr.clone()
            rows = arr[ids]
            new[ids] = (v if self.mode == "set" else rows * v).expand(rows.shape)
            return model.replace(**{self.field: new})
        if shared:
            arr = arr.expand((v.shape[0],) + tuple(arr.shape))
        new = arr.clone()
        rows = arr[:, ids]
        new[:, ids] = (v if self.mode == "set" else rows * v).expand(rows.shape)
        return _per_env(model, {self.field: new})


def apply_modifiers(model: Model, modifiers: List[Tuple[str, Modifier]],
                    parameters: Dict[str, Any]) -> Model:
    """Run every registered (parameter_name, modifier) pair against the
    current parameter values (robot_env.py:512-520 semantics). Parameters
    whose name is missing from `parameters` are skipped."""
    for name, mod in modifiers:
        if name in parameters:
            model = mod(model, parameters[name])
    return model
