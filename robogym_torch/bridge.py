"""Carry a compiled model and a simulation state across packages.

`model_to_numpy` and `data_to_numpy` read any object whose fields carry the
`Model`/`Data` field names (the JAX package's pytrees or this port's
dataclasses) through `dataclasses.fields` and `np.asarray`; they are
duck-typed and import neither JAX nor the JAX package. The result is a flat
dict of numpy arrays that `np.savez` can store:

  * `model.<field>`, `opt.<field>`, `const.<field>` for a model, with the
    const's `body_tree` and `names` as JSON text;
  * `<field>` and `contact.<field>` for a state, each with its leading
    env axis.

`model_from_numpy` and `data_from_numpy` build the port's `Model`/`Data` on
a device from such a dict. `env_state_to_numpy` and `env_state_from_numpy`
do the same for an env state (`physics.<field>`, `goal.<key>`,
`prev_goal_distance.<key>`, `tracker.<field>`, `model_fields.<name>` and
`t`, each with its leading env axis; `goal_aux` as one array, or, where it
is a tree (a wrapper stack's `(inner goal_aux, transform states)`), as
`goal_aux.tree`, its structure in JSON, and its leaves `goal_aux.<i>`);
the JAX state's PRNG key is not carried. `mesh_bank_from_numpy` builds the
port's mesh object bank from a bank's arrays (the JAX package's
`MeshObjectBank` or the port's), as the weights of a model are carried.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict

import numpy as np
import torch

from robogym_torch.mjcf.model import (
    OPTION_STATIC, OPTION_TENSORS, Contact, Data, Model, ModelConst, Option,
)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _fields(obj):
    return [f.name for f in dataclasses.fields(obj)]


def model_to_numpy(model) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name in _fields(model):
        if name in ("const", "opt", "env_fields"):
            continue
        v = getattr(model, name)
        if v is not None:
            out["model." + name] = _np(v)
    for name in OPTION_TENSORS:
        out["opt." + name] = _np(getattr(model.opt, name))
    for name in OPTION_STATIC:
        out["opt." + name] = np.asarray(getattr(model.opt, name))
    const = model.const
    for name in _fields(ModelConst):
        v = getattr(const, name)
        if name == "body_tree":
            out["const.body_tree"] = np.asarray(json.dumps([list(map(int, lvl)) for lvl in v]))
        elif name == "names":
            out["const.names"] = np.asarray(json.dumps(v, sort_keys=True))
        elif v is not None:
            out["const." + name] = np.asarray(v)
    return out


def const_from_numpy(arrays, cls=ModelConst):
    """A `ModelConst` from a `model_to_numpy` dict. `cls` may be any
    dataclass with the same field names (the JAX package's `ModelConst`)."""
    kw = {}
    for f in dataclasses.fields(cls):
        key = "const." + f.name
        if key not in arrays:
            continue
        v = np.asarray(arrays[key])
        if f.name == "body_tree":
            kw[f.name] = tuple(tuple(lvl) for lvl in json.loads(str(v)))
        elif f.name == "names":
            kw[f.name] = json.loads(str(v))
        elif f.type in ("int", int):
            kw[f.name] = int(v)
        else:
            kw[f.name] = np.array(v)
    return cls(**kw)


def option_static(arrays) -> Dict:
    """The static (non-tensor) `Option` fields of a `model_to_numpy` dict."""
    out = {}
    for name in OPTION_STATIC:
        v = np.asarray(arrays["opt." + name])
        out[name] = str(v) if v.dtype.kind == "U" else v.item()
    return out


def model_from_numpy(arrays, device="cuda") -> Model:
    """The port's Model on `device` from a `model_to_numpy` dict (or an
    opened npz)."""
    device = torch.device(device)

    def t(key):
        return torch.as_tensor(np.array(arrays[key]), device=device)

    opt_kw = {name: t("opt." + name) for name in OPTION_TENSORS}
    opt_kw.update(option_static(arrays))
    kw = {}
    for f in dataclasses.fields(Model):
        if f.name in ("const", "opt"):
            continue
        key = "model." + f.name
        if key in arrays:
            kw[f.name] = t(key)
    return Model(const=const_from_numpy(arrays), opt=Option(**opt_kw), **kw)


def mesh_bank_from_numpy(bank, device="cuda"):
    """The port's `MeshObjectBank` on `device` from any object with its
    fields (`names`, then `hull_vert`, `hull_mask`, `mass`, `inertia`,
    `iquat`, `bbox_half` as arrays), each array's values and dtype kept."""
    from robogym_torch.envs.rearrange.mesh import MeshObjectBank

    return MeshObjectBank(names=tuple(bank.names), **{
        f.name: torch.as_tensor(np.array(getattr(bank, f.name)), device=device)
        for f in dataclasses.fields(MeshObjectBank) if f.name != "names"})


def model_to(model: Model, device, dtype=None) -> Model:
    """The same model with every tensor on `device`, and its floating
    tensors in `dtype` if given."""
    device = torch.device(device)
    if model.device == device and dtype in (None, model.dtype):
        return model

    def to(v):
        return v.to(device, dtype) if dtype is not None and v.is_floating_point() else v.to(device)

    kw = {}
    for name in _fields(model):
        v = getattr(model, name)
        if isinstance(v, torch.Tensor):
            kw[name] = to(v)
    opt = dataclasses.replace(model.opt, **{n: to(getattr(model.opt, n)) for n in OPTION_TENSORS})
    return dataclasses.replace(model, opt=opt, **kw)


def data_to_numpy(data) -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name in _fields(data):
        v = getattr(data, name)
        if name == "contact":
            for cname in _fields(v):
                out["contact." + cname] = _np(getattr(v, cname))
        else:
            out[name] = _np(v)
    return out


def data_from_numpy(arrays, device="cuda") -> Data:
    """The port's Data on `device`; every array keeps its leading env axis
    and its dtype."""
    device = torch.device(device)

    def t(key):
        return torch.as_tensor(np.array(arrays[key]), device=device)

    contact = Contact(**{f.name: t("contact." + f.name) for f in dataclasses.fields(Contact)})
    kw = {f.name: t(f.name) for f in dataclasses.fields(Data) if f.name != "contact"}
    return Data(contact=contact, **kw)


def _flatten(tree, leaves):
    """The JSON-able structure of a tree of dicts, tuples, lists, None and
    arrays, its arrays appended to `leaves` (as numpy)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {"dict": {k: _flatten(v, leaves) for k, v in tree.items()}}
    if isinstance(tree, (tuple, list)):
        return {"seq": [_flatten(v, leaves) for v in tree]}
    leaves.append(_np(tree))
    return len(leaves) - 1


def _unflatten(spec, leaf):
    """The tree of `_flatten`'s `spec`, each leaf index i given by leaf(i)."""
    if spec is None:
        return None
    if isinstance(spec, int):
        return leaf(spec)
    if "dict" in spec:
        return {k: _unflatten(v, leaf) for k, v in spec["dict"].items()}
    return tuple(_unflatten(v, leaf) for v in spec["seq"])


def env_state_to_numpy(state) -> Dict[str, np.ndarray]:
    """A batched env state (the JAX package's `EnvState` or the port's) as
    a flat dict of numpy arrays: `goal_aux` as a Data (the rearrange env's
    solver sim, `goal_aux.data.<field>`), a tree or an array, and
    `robot_aux`, where set, as its fields (`robot_aux.<field>`)."""
    out = {"physics." + k: v for k, v in data_to_numpy(state.physics).items()}
    for group in ("goal", "prev_goal_distance"):
        for k, v in getattr(state, group).items():
            out[f"{group}.{k}"] = _np(v)
    for name in _fields(state.tracker):
        out["tracker." + name] = _np(getattr(state.tracker, name))
    for k, v in (state.model_fields or {}).items():
        out["model_fields." + k] = _np(v)
    if _is_data(state.goal_aux):
        out.update({"goal_aux.data." + k: v for k, v in data_to_numpy(state.goal_aux).items()})
    elif isinstance(state.goal_aux, (tuple, list, dict)):
        leaves = []
        out["goal_aux.tree"] = np.asarray(json.dumps(_flatten(state.goal_aux, leaves)))
        out.update({f"goal_aux.{i}": v for i, v in enumerate(leaves)})
    else:
        out["goal_aux"] = _np(state.goal_aux)
    robot_aux = getattr(state, "robot_aux", None)
    if robot_aux is not None:
        for name in _fields(robot_aux):
            out["robot_aux." + name] = _np(getattr(robot_aux, name))
    out["t"] = _np(state.t)
    return out


def _is_data(x) -> bool:
    """A physics state (either package's Data), not a tree of arrays."""
    return dataclasses.is_dataclass(x) and hasattr(x, "qpos") and hasattr(x, "contact")


def env_state_from_numpy(arrays, device="cuda"):
    """The port's `EnvState` on `device` from an `env_state_to_numpy` dict."""
    from robogym_torch.envs.core import EnvState, TrackerState

    device = torch.device(device)

    def t(key):
        return torch.as_tensor(np.array(arrays[key]), device=device)

    def group(prefix):
        return {k[len(prefix):]: t(k) for k in arrays if k.startswith(prefix)}

    physics = data_from_numpy({k[8:]: v for k, v in arrays.items() if k.startswith("physics.")},
                              device)
    tracker = TrackerState(**{f.name: t("tracker." + f.name)
                              for f in dataclasses.fields(TrackerState)})
    if any(k.startswith("goal_aux.data.") for k in arrays):
        goal_aux = data_from_numpy({k[14:]: v for k, v in arrays.items()
                                    if k.startswith("goal_aux.data.")}, device)
    elif "goal_aux.tree" in arrays:
        goal_aux = _unflatten(json.loads(str(arrays["goal_aux.tree"])),
                              lambda i: t(f"goal_aux.{i}"))
    else:
        goal_aux = t("goal_aux")
    robot_aux = group("robot_aux.")
    if robot_aux:
        from robogym_torch.robot.gripper import RegraspState

        robot_aux = RegraspState(**robot_aux)
    return EnvState(physics=physics, goal=group("goal."), goal_aux=goal_aux,
                    prev_goal_distance=group("prev_goal_distance."), tracker=tracker, t=t("t"),
                    model_fields=group("model_fields.") or None, robot_aux=robot_aux or None)
