"""The Shadow Hand, batched: name tables, the 20 <-> 24 coupled-joint
projections, [-1, 1] position actions (relative or absolute), effort
control and the hand's observations.

Counterpart of `robogym_tpu/robot/shadow_hand.py`; every state tensor
carries a leading env axis `(B, ...)`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from robogym_torch.mjcf.model import BiasType, Data, GainType, Model

ACTUATORS: List[str] = [
    "A_WRJ1", "A_WRJ0",
    "A_FFJ3", "A_FFJ2", "A_FFJ1",
    "A_MFJ3", "A_MFJ2", "A_MFJ1",
    "A_RFJ3", "A_RFJ2", "A_RFJ1",
    "A_LFJ4", "A_LFJ3", "A_LFJ2", "A_LFJ1",
    "A_THJ4", "A_THJ3", "A_THJ2", "A_THJ1", "A_THJ0",
]

JOINTS: List[str] = [
    "WRJ1", "WRJ0",
    "FFJ3", "FFJ2", "FFJ1", "FFJ0",
    "MFJ3", "MFJ2", "MFJ1", "MFJ0",
    "RFJ3", "RFJ2", "RFJ1", "RFJ0",
    "LFJ4", "LFJ3", "LFJ2", "LFJ1", "LFJ0",
    "THJ4", "THJ3", "THJ2", "THJ1", "THJ0",
]

# actuator -> actuated joints (the coupled *FJ1/*FJ0 pairs share one actuator)
ACTUATOR_JOINT_MAPPING: Dict[str, List[str]] = {
    "A_WRJ1": ["WRJ1"], "A_WRJ0": ["WRJ0"],
    "A_FFJ3": ["FFJ3"], "A_FFJ2": ["FFJ2"], "A_FFJ1": ["FFJ1", "FFJ0"],
    "A_MFJ3": ["MFJ3"], "A_MFJ2": ["MFJ2"], "A_MFJ1": ["MFJ1", "MFJ0"],
    "A_RFJ3": ["RFJ3"], "A_RFJ2": ["RFJ2"], "A_RFJ1": ["RFJ1", "RFJ0"],
    "A_LFJ4": ["LFJ4"], "A_LFJ3": ["LFJ3"], "A_LFJ2": ["LFJ2"],
    "A_LFJ1": ["LFJ1", "LFJ0"],
    "A_THJ4": ["THJ4"], "A_THJ3": ["THJ3"], "A_THJ2": ["THJ2"],
    "A_THJ1": ["THJ1"], "A_THJ0": ["THJ0"],
}

FINGERTIP_SITE_NAMES: List[str] = [
    "S_fftip", "S_mftip", "S_rftip", "S_lftip", "S_thtip",
]


def _projection_matrices():
    """Position <-> control projections (hand_interface.py:245-266)."""
    p2c = np.zeros((20, 24))
    c2p = np.zeros((24, 20))
    aid = {a: i for i, a in enumerate(ACTUATORS)}
    jid = {j: i for i, j in enumerate(JOINTS)}
    for act, joints in ACTUATOR_JOINT_MAPPING.items():
        v = 1.0 / len(joints)
        for j in joints:
            p2c[aid[act], jid[j]] = 1.0
            c2p[jid[j], aid[act]] = v
    return p2c, c2p


POSITION_TO_CONTROL_MATRIX, CONTROL_TO_POSITION_MATRIX = _projection_matrices()


@dataclasses.dataclass(frozen=True)
class HandIndex:
    """Index tables binding the hand's names to a compiled Model."""

    prefix: str
    actuator_ids: np.ndarray        # (20,) model actuator ids in ACTUATORS order
    joint_ids: np.ndarray           # (24,) model joint ids in JOINTS order
    joint_qpos_ids: np.ndarray      # (24,) qpos addresses in JOINTS order
    joint_dof_ids: np.ndarray       # (24,)
    fingertip_site_ids: np.ndarray  # (5,)

    @classmethod
    def build(cls, model: Model, prefix: str = "robot0:") -> "HandIndex":
        c = model.const
        jids = [c.names["joint"][prefix + j] for j in JOINTS]
        return cls(
            prefix=prefix,
            actuator_ids=np.asarray([c.names["actuator"][prefix + a] for a in ACTUATORS],
                                    np.int64),
            joint_ids=np.asarray(jids, np.int64),
            joint_qpos_ids=np.asarray([c.jnt_qposadr[j] for j in jids], np.int64),
            joint_dof_ids=np.asarray([c.jnt_dofadr[j] for j in jids], np.int64),
            fingertip_site_ids=np.asarray(
                [c.names["site"][prefix + s] for s in FINGERTIP_SITE_NAMES], np.int64),
        )


def _ix(ids: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(ids, dtype=torch.long, device=like.device)


def joint_positions(idx: HandIndex, d: Data) -> torch.Tensor:
    """(B, 24) joint angles in JOINTS order."""
    return d.qpos[:, _ix(idx.joint_qpos_ids, d.qpos)]


def joint_velocities(idx: HandIndex, d: Data) -> torch.Tensor:
    return d.qvel[:, _ix(idx.joint_dof_ids, d.qvel)]


def fingertip_positions(idx: HandIndex, d: Data) -> torch.Tensor:
    """(B, 15) fingertip site positions, flattened per env."""
    return d.site_xpos[:, _ix(idx.fingertip_site_ids, d.site_xpos)].reshape(d.qpos.shape[0], -1)


def ctrl_range(idx: HandIndex, m: Model) -> torch.Tensor:
    """(20, 2) actuator control ranges in ACTUATORS order, or (B, 20, 2)
    where the model's ranges are each env's own."""
    return m.take("actuator_ctrlrange", _ix(idx.actuator_ids, m.actuator_ctrlrange))


def joint_positions_to_control(qpos_hand: torch.Tensor) -> torch.Tensor:
    """(B, 24) joint positions -> (B, 20) actuator positions
    (hand_interface.py:400-405)."""
    p2c = torch.as_tensor(POSITION_TO_CONTROL_MATRIX, dtype=qpos_hand.dtype,
                          device=qpos_hand.device)
    return qpos_hand @ p2c.T


def denormalize_position_control(idx: HandIndex, m: Model, d: Data,
                                 position_control: torch.Tensor, relative_action: bool = False,
                                 max_position_change: float | None = None) -> torch.Tensor:
    """(B, 20) actions in [-1, 1] -> the full (B, nu) ctrl with the hand's
    actuators set, in radians (robot_interface.py:247-278)."""
    cr = ctrl_range(idx, m)
    lo, hi = cr[..., 0], cr[..., 1]
    if relative_action:
        actuation_center = joint_positions_to_control(joint_positions(idx, d))
    else:
        actuation_center = (hi + lo) / 2.0
    arange = (hi - lo) / 2.0
    if relative_action and max_position_change is not None:
        arange = torch.clamp(arange, max=max_position_change)
    ctrl = torch.minimum(torch.maximum(actuation_center + position_control * arange, lo), hi)
    full = d.ctrl.clone()
    full[:, _ix(idx.actuator_ids, full)] = ctrl.to(full.dtype)
    return full


def zero_control(batch: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(B, 20) zero actions: the hand straightened to its ranges' centres."""
    return torch.zeros((batch, len(ACTUATORS)), dtype=dtype, device=device)


def normalize_by_limits(values: torch.Tensor, limits: torch.Tensor) -> torch.Tensor:
    """Scale `values` into [-1, 1] by asymmetric `limits` (N, 2), keeping 0
    fixed (hand_utils.py:21-28)."""
    return torch.where(values < 0, torch.abs(values) / limits[:, 0], values / limits[:, 1])


def denormalize_by_limit(interpolation: torch.Tensor, limits: torch.Tensor) -> torch.Tensor:
    """[-1, 1] -> asymmetric limits (N, 2), keeping 0 fixed
    (hand_utils.py:12-18)."""
    return torch.where(interpolation < 0, limits[:, 0] * torch.abs(interpolation),
                       limits[:, 1] * interpolation)


# ---------------------------------------------------------------------------
# effort (torque) control
# ---------------------------------------------------------------------------


def effort_control_model(idx: HandIndex, m: Model) -> Model:
    """The model with the hand's actuators in effort (direct-torque) mode:
    FIXED gain 1, no bias, control range [-1, 1]
    (mujoco_shadow_hand.py:139-156). The gain and bias types are the
    const's structure, and the actuator partition and the index tables are
    cached on the const (`physics.actuation`, `physics.tables.on_device`),
    so the effort model gets a new const (`dataclasses.replace`), which
    carries none of the position model's caches."""
    c = m.const
    ids = np.asarray(idx.actuator_ids)
    gt = np.array(c.actuator_gaintype, copy=True)
    bt = np.array(c.actuator_biastype, copy=True)
    gt[ids] = GainType.FIXED
    bt[ids] = BiasType.NONE
    const = dataclasses.replace(c, actuator_gaintype=gt, actuator_biastype=bt)
    jids = _ix(ids, m.actuator_gainprm)
    gp = m.actuator_gainprm.clone()
    gp[jids, 0] = 1.0
    bp = m.actuator_biasprm.clone()
    bp[jids] = 0.0
    cr = m.actuator_ctrlrange.clone()
    cr[jids, 0] = -1.0
    cr[jids, 1] = 1.0
    return m.replace(const=const, actuator_gainprm=gp, actuator_biasprm=bp,
                     actuator_ctrlrange=cr)


def set_effort_control(idx: HandIndex, m: Model, d: Data, control: torch.Tensor) -> torch.Tensor:
    """(B, 20) effort commands in [-1, 1] -> the full (B, nu) ctrl: each
    denormalized by its actuator's force limits
    (mujoco_shadow_hand.py:139-156). With a model from
    `effort_control_model`, ctrl is the force."""
    ids = _ix(idx.actuator_ids, d.ctrl)
    force = denormalize_by_limit(control, m.actuator_forcerange[ids])
    full = d.ctrl.clone()
    full[:, ids] = force.to(full.dtype)
    return full


def actuator_effort(idx: HandIndex, m: Model, d: Data) -> torch.Tensor:
    """(B, 20) applied actuator force normalized to [-1, 1] by the force
    limits, the MuJoCoObservation.actuator_effort channel
    (mujoco_shadow_hand.py:44-55)."""
    ids = _ix(idx.actuator_ids, d.actuator_force)
    return normalize_by_limits(d.actuator_force[:, ids], m.actuator_forcerange[ids])
