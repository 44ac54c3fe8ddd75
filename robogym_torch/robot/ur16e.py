"""The UR16e arm, batched: name tables, joint and TCP observations, joint
position control through the cascaded-PI actuators, and the safety-stop
threshold.

Counterpart of `robogym_tpu/robot/ur16e.py`; every state tensor carries a
leading env axis `(B, ...)`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from robogym_torch.mjcf.model import Data, Model
from robogym_torch.utils import rotation as rot

JOINTS: List[str] = ["J1", "J2", "J3", "J4", "J5", "J6"]
ACTUATORS: List[str] = [f"ur_actuator_{i}" for i in range(1, 7)]

# the tabletop experiment's initial joint positions (arm_interface.py:27)
TABLETOP_EXPERIMENT_INITIAL_POS = np.deg2rad(
    np.array([135.0, -90.0, 135.0, -100.0, -240.0, 135.0]))

# |F_tcp| above which the arm's safety stop triggers (arm_interface.py:43-46)
SAFETY_STOP_FORCE_THRESHOLD = 120.0


@dataclasses.dataclass(frozen=True)
class ArmIndex:
    """Index tables binding the arm's names to a compiled Model."""

    prefix: str
    joint_ids: np.ndarray        # (6,)
    joint_qpos_ids: np.ndarray   # (6,)
    joint_dof_ids: np.ndarray    # (6,)
    actuator_ids: np.ndarray     # (6,), or (0,) in a mocap-actuated world
    tcp_body_id: int             # robot0:gripper_tcp
    mocap_body_id: int           # robot0:mocap, -1 if absent

    @classmethod
    def build(cls, model: Model, prefix: str = "robot0:") -> "ArmIndex":
        c = model.const
        jn, an, bn = c.names["joint"], c.names["actuator"], c.names["body"]
        jids = [jn[prefix + j] for j in JOINTS]
        return cls(
            prefix=prefix,
            joint_ids=np.asarray(jids, np.int64),
            joint_qpos_ids=np.asarray([c.jnt_qposadr[j] for j in jids], np.int64),
            joint_dof_ids=np.asarray([c.jnt_dofadr[j] for j in jids], np.int64),
            actuator_ids=np.asarray([an[a] for a in ACTUATORS if a in an], np.int64),
            tcp_body_id=int(bn[prefix + "gripper_tcp"]),
            mocap_body_id=int(bn.get(prefix + "mocap", -1)),
        )


def _ix(ids, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=like.device)


def joint_positions(idx: ArmIndex, d: Data) -> torch.Tensor:
    return d.qpos[:, _ix(idx.joint_qpos_ids, d.qpos)]


def joint_velocities(idx: ArmIndex, d: Data) -> torch.Tensor:
    return d.qvel[:, _ix(idx.joint_dof_ids, d.qvel)]


def tcp_xyz(idx: ArmIndex, d: Data) -> torch.Tensor:
    """(B, 3) the TCP body's world position."""
    return d.xpos[:, idx.tcp_body_id]


def tcp_quat(idx: ArmIndex, d: Data) -> torch.Tensor:
    return d.xquat[:, idx.tcp_body_id]


def tcp_rot(idx: ArmIndex, d: Data) -> torch.Tensor:
    return rot.quat2euler(d.xquat[:, idx.tcp_body_id])


def tcp_vel(idx: ArmIndex, m: Model, d: Data) -> torch.Tensor:
    """(B, 3) the TCP's linear velocity: the body's cvel row (angular,
    linear at the root's subtree com) shifted to the body origin."""
    rootid = int(np.asarray(m.const.body_rootid)[idx.tcp_body_id])
    ang = d.cvel[:, idx.tcp_body_id, :3]
    lin = d.cvel[:, idx.tcp_body_id, 3:]
    offset = d.xpos[:, idx.tcp_body_id] - d.subtree_com[:, rootid]
    return lin + rot.cross(ang, offset)


def denormalize_position_control(idx: ArmIndex, m: Model, d: Data,
                                 position_control: torch.Tensor, relative_action: bool = True,
                                 max_position_change: Optional[float] = 2.4) -> torch.Tensor:
    """Actions (B, 6) in [-1, 1] -> the whole ctrl (B, nu) with the arm's
    joint targets written (robot_interface.py:247-278, with the JOINT
    mode's per-joint max_position_change)."""
    ids = _ix(idx.actuator_ids, d.ctrl)
    cr = m.take("actuator_ctrlrange", ids)
    lo, hi = cr[..., 0], cr[..., 1]
    center = joint_positions(idx, d) if relative_action else (hi + lo) / 2.0
    arange = (hi - lo) / 2.0
    if relative_action and max_position_change is not None:
        arange = torch.clamp(arange, max=max_position_change)
    ctrl = d.ctrl.clone()
    ctrl[:, ids] = torch.minimum(torch.maximum(center + position_control * arange, lo), hi)
    return ctrl
