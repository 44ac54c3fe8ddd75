"""Shadow Hand per-actuator parameter configurer (the calibration
interface).

Counterpart of `robogym_tpu/robot/parameter_manager.py` (the original
robogym's MuJoCoParameterManager): an actuator's assignment dict (PID gain
parameters, force range, spring-tendon stiffness, rest length and range,
coupling-pulley radius, per-joint damping and joint limits) set on a
`Model` and read back, with the calibration search bounds.

Every target is a `Model` tensor, so `set_parameters` returns a new
`Model` with the fields replaced (the old one untouched); a per-env field
(`Model.env_fields`) is set in every env. Names resolve to ids on the
host, once per model.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from robogym_torch.mjcf.model import Model
from robogym_torch.robot.shadow_hand import ACTUATOR_JOINT_MAPPING, ACTUATORS

# actuators whose distal joint pair is driven through a spring tendon
_SPRING_TENDON_ACTUATORS = ("A_FFJ1", "A_MFJ1", "A_RFJ1", "A_LFJ1")

_GAINPRM_KEYS = (
    "actuator_gainprm_kp", "actuator_gainprm_ti", "actuator_gainprm_iclamp",
    "actuator_gainprm_td", "actuator_gainprm_dsmooth",
    "actuator_gainprm_error_deadband",
)


def has_spring_tendon(actuator: str) -> bool:
    return actuator in _SPRING_TENDON_ACTUATORS


def spring_tendon_name(actuator: str) -> str:
    assert has_spring_tendon(actuator)
    return actuator.replace("A_", "")[:-2] + "T2"


def _set(m: Model, name: str, index, value) -> Model:
    """`m` with entry `index` of field `name` set to `value` (in every env
    of a per-env field)."""
    t = getattr(m, name).clone()
    t[(Ellipsis,) + tuple(index)] = value
    return m.replace(**{name: t})


def _get(m: Model, name: str, *index) -> float:
    if m.per_env(name):
        raise ValueError(f"{name} is per env: read one env's model "
                         "(envs.core.take_model_envs)")
    return float(getattr(m, name)[index])


class ShadowHandParameterManager:
    """The parameter manager of one compiled model: ids resolved once."""

    def __init__(self, model: Model, hand_prefix: str = "robot0:"):
        c = model.const
        self.prefix = hand_prefix
        self.actuator_id = {a: c.names["actuator"][hand_prefix + a] for a in ACTUATORS}
        self.joint_dof = {}
        self.joint_id = {}
        for joints in ACTUATOR_JOINT_MAPPING.values():
            for j in joints:
                jid = c.names["joint"][hand_prefix + j]
                self.joint_id[j] = jid
                self.joint_dof[j] = int(np.asarray(c.jnt_dofadr)[jid])
        self.tendon_id = {
            a: c.names["tendon"][hand_prefix + spring_tendon_name(a)]
            for a in _SPRING_TENDON_ACTUATORS
            if hand_prefix + spring_tendon_name(a) in c.names["tendon"]
        }
        self.pulley_geom = {}
        for a in _SPRING_TENDON_ACTUATORS:
            for j in ACTUATOR_JOINT_MAPPING[a]:
                g = f"{hand_prefix}coupling_{j}_pulley"
                if g in c.names["geom"]:
                    self.pulley_geom[j] = c.names["geom"][g]

    def set_parameters(self, m: Model, actuator: str, assignments: Dict[str, float]) -> Model:
        """A model with one actuator's assignment dict applied (the force
        range symmetric, the tendon range's upper end)."""
        assert actuator in ACTUATORS
        aid = self.actuator_id[actuator]
        for slot, key in enumerate(_GAINPRM_KEYS):
            if key in assignments:
                m = _set(m, "actuator_gainprm", (aid, slot), assignments[key])
        if "actuator_forcerange" in assignments:
            fr = assignments["actuator_forcerange"]
            m = _set(_set(m, "actuator_forcerange", (aid, 0), -fr), "actuator_forcerange",
                     (aid, 1), fr)

        if actuator in self.tendon_id:
            tid = self.tendon_id[actuator]
            for key, index in (("tendon_stiffness", (tid,)), ("tendon_lengthspring", (tid,)),
                               ("tendon_range", (tid, 1))):
                if key in assignments:
                    m = _set(m, key, index, assignments[key])
            for j in ACTUATOR_JOINT_MAPPING[actuator]:
                key = f"{j}_tendon_geom_0"
                if key in assignments and j in self.pulley_geom:
                    m = _set(m, "geom_size", (self.pulley_geom[j], 0), assignments[key])

        for j in ACTUATOR_JOINT_MAPPING[actuator]:
            jid, dof = self.joint_id[j], self.joint_dof[j]
            if f"{j}_dof_damping" in assignments:
                m = _set(m, "dof_damping", (dof,), assignments[f"{j}_dof_damping"])
            for end in (0, 1):
                if f"{j}_jnt_range_{end}" in assignments:
                    m = _set(m, "jnt_range", (jid, end), assignments[f"{j}_jnt_range_{end}"])
        return m

    def current_parameters(self, m: Model, actuator: str) -> Dict[str, float]:
        """The actuator's assignment dict as `m` holds it (shared fields;
        a per-env field raises)."""
        assert actuator in ACTUATORS
        aid = self.actuator_id[actuator]
        out = {key: _get(m, "actuator_gainprm", aid, slot)
               for slot, key in enumerate(_GAINPRM_KEYS)}
        out["actuator_forcerange"] = _get(m, "actuator_forcerange", aid, 1)
        if actuator in self.tendon_id:
            tid = self.tendon_id[actuator]
            out["tendon_stiffness"] = _get(m, "tendon_stiffness", tid)
            out["tendon_lengthspring"] = _get(m, "tendon_lengthspring", tid)
            out["tendon_range"] = _get(m, "tendon_range", tid, 1)
            for j in ACTUATOR_JOINT_MAPPING[actuator]:
                if j in self.pulley_geom:
                    out[f"{j}_tendon_geom_0"] = _get(m, "geom_size", self.pulley_geom[j], 0)
        for j in ACTUATOR_JOINT_MAPPING[actuator]:
            out[f"{j}_dof_damping"] = _get(m, "dof_damping", self.joint_dof[j])
            out[f"{j}_jnt_range_0"] = _get(m, "jnt_range", self.joint_id[j], 0)
            out[f"{j}_jnt_range_1"] = _get(m, "jnt_range", self.joint_id[j], 1)
        return out

    def parameter_bounds(self, m: Model, actuator: str) -> Dict[str, list]:
        """The calibration search bounds around the current parameters."""
        cur = self.current_parameters(m, actuator)
        b = {
            "actuator_gainprm_kp": [0.25 * cur["actuator_gainprm_kp"],
                                    4 * cur["actuator_gainprm_kp"]],
            "actuator_gainprm_ti": [0.25 * cur["actuator_gainprm_ti"],
                                    4 * cur["actuator_gainprm_ti"] + 10.0],
            "actuator_gainprm_iclamp": [0.25 * cur["actuator_gainprm_iclamp"],
                                        4 * cur["actuator_gainprm_iclamp"] + 10.0],
            "actuator_gainprm_td": [0.25 * cur["actuator_gainprm_td"],
                                    4 * cur["actuator_gainprm_td"] + 0.1],
            "actuator_gainprm_dsmooth": [0.0, 0.2],
            "actuator_gainprm_error_deadband": [0.0, 0.03],
            "actuator_forcerange": [0.25 * cur["actuator_forcerange"],
                                    4 * cur["actuator_forcerange"]],
        }
        if actuator in self.tendon_id:
            for key in ("tendon_stiffness", "tendon_lengthspring", "tendon_range"):
                b[key] = [0.25 * cur[key], 4 * cur[key]]
            for j in ACTUATOR_JOINT_MAPPING[actuator]:
                key = f"{j}_tendon_geom_0"
                if key in cur:
                    b[key] = [0.25 * cur[key], 4 * cur[key]]
        for j in ACTUATOR_JOINT_MAPPING[actuator]:
            b[f"{j}_dof_damping"] = [0.01, 0.75]
            b[f"{j}_jnt_range_0"] = [cur[f"{j}_jnt_range_0"] - 0.25,
                                     cur[f"{j}_jnt_range_0"] + 0.25]
            b[f"{j}_jnt_range_1"] = [cur[f"{j}_jnt_range_1"] - 0.25,
                                     cur[f"{j}_jnt_range_1"] + 0.25]
        return b
