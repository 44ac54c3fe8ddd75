"""TCP (tool-centre-point) control through the mocap weld, batched: the
action is a TCP position delta and a set of rotation dofs; the mocap
body's pose is reset to the TCP's and advanced by the deltas, and the
world's `mocap_weld` equality drags the arm after it.

Counterpart of `robogym_tpu/robot/tcp_solver.py`; mocap state is
`(B, nmocap, 3)` / `(B, nmocap, 4)`.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from robogym_torch.mjcf.model import Data, Model
from robogym_torch.utils import rotation as rot


class PrincipalAxis:
    """(solver.py:10-14). Values are euler-angle indices."""

    ROLL = 0
    PITCH = 2
    YAW = 1


# (free_dof_tcp_arm.py:13-17)
DOF_DIM_SPEED_SCALE = {
    PrincipalAxis.ROLL: np.deg2rad(200),
    PrincipalAxis.PITCH: np.deg2rad(600),
    PrincipalAxis.YAW: np.deg2rad(300),
}

# control-mode dof sets (free_dof_tcp_arm.py:239-254)
TCP_WRIST_DOFS = (PrincipalAxis.PITCH,)
TCP_WRIST_ALIGN: Optional[int] = PrincipalAxis.PITCH
TCP_ROLL_YAW_DOFS = (PrincipalAxis.ROLL, PrincipalAxis.PITCH)
TCP_ROLL_YAW_ALIGN: Optional[int] = None


def align_axis(cmd_quat: torch.Tensor, axis: int) -> torch.Tensor:
    """(mocap_solver.py:59-74): turn each quat (B, 4) so that its column
    closest to world axis `axis` lies exactly on it."""
    mtx = rot.quat2mat(cmd_quat)
    axis_nr = torch.argmax(torch.abs(mtx[:, axis, :]), dim=-1)
    col = torch.gather(mtx, 2, axis_nr[:, None, None].expand(-1, 3, 1))[..., 0]
    col = col * torch.sign(col[:, axis])[:, None]
    alignment = torch.zeros(3, dtype=cmd_quat.dtype, device=cmd_quat.device)
    alignment[axis] = 1.0
    return rot.quat_mul(rot.vectors2quat(col, alignment.expand_as(col)), cmd_quat)


def get_tcp_quat_delta(d: Data, tcp_body: int, angle_ctrl: torch.Tensor,
                       dof_axes: Tuple[int, ...], alignment_axis: Optional[int]) -> torch.Tensor:
    """(mocap_solver.py:33-50): the quaternion delta (B, 4), to be added
    to the mocap quat, that turns the TCP about the controlled axes by
    angle_ctrl (B, len(dof_axes))."""
    euler = torch.zeros(angle_ctrl.shape[:1] + (3,), dtype=angle_ctrl.dtype,
                        device=angle_ctrl.device)
    for i, ax in enumerate(dof_axes):
        euler[:, ax] = angle_ctrl[:, i]
    gripper_quat = d.xquat[:, tcp_body]
    target = rot.quat_mul(gripper_quat, rot.euler2quat(euler))
    if alignment_axis is not None:
        target = align_axis(target, alignment_axis)
    return target - gripper_quat


def reset_mocap_to_body(d: Data, tcp_body: int, mocapid: int = 0) -> Data:
    """The mocap body's pose set to the TCP body's (reset_mocap2body_xpos)."""
    mocap_pos, mocap_quat = d.mocap_pos.clone(), d.mocap_quat.clone()
    mocap_pos[:, mocapid] = d.xpos[:, tcp_body]
    mocap_quat[:, mocapid] = d.xquat[:, tcp_body]
    return d.replace(mocap_pos=mocap_pos, mocap_quat=mocap_quat)


def mocap_set_action(d: Data, pos_delta: torch.Tensor, quat_delta: torch.Tensor,
                     tcp_body: int, mocapid: int = 0) -> Data:
    """utils.mocap_set_action (mocap_solver.py:52-53): the mocap target
    reset to the TCP's pose, then advanced by the deltas (B, 3), (B, 4);
    the quat is renormalised in the kinematics."""
    d = reset_mocap_to_body(d, tcp_body, mocapid)
    mocap_pos, mocap_quat = d.mocap_pos.clone(), d.mocap_quat.clone()
    mocap_pos[:, mocapid] = mocap_pos[:, mocapid] + pos_delta.to(mocap_pos.dtype)
    mocap_quat[:, mocapid] = mocap_quat[:, mocapid] + quat_delta.to(mocap_quat.dtype)
    return d.replace(mocap_pos=mocap_pos, mocap_quat=mocap_quat)


def tcp_set_position_control(m: Model, d: Data, tcp_body: int, action: torch.Tensor,
                             control_mode: str, max_position_change: float) -> Data:
    """A TCP action (B, 3 + rotation dofs) in [-1, 1] applied to the mocap
    target (free_dof_tcp_arm.py:162-209)."""
    from robogym_torch.robot.composite import ControlMode

    if control_mode == ControlMode.TCP_WRIST:
        dof_axes, align = TCP_WRIST_DOFS, TCP_WRIST_ALIGN
    else:
        dof_axes, align = TCP_ROLL_YAW_DOFS, TCP_ROLL_YAW_ALIGN
    pos_delta = action[:, :3] * max_position_change
    speed = torch.tensor([DOF_DIM_SPEED_SCALE[a] * max_position_change for a in dof_axes],
                         dtype=action.dtype, device=action.device)
    angle_ctrl = action[:, 3:3 + len(dof_axes)] * speed
    quat_delta = get_tcp_quat_delta(d, tcp_body, angle_ctrl, dof_axes, align)
    return mocap_set_action(d, pos_delta, quat_delta, tcp_body)
