"""The composite arm-and-gripper robot: control modes, the robot control
parameters, the index of both parts, and joint position control of the
composite action [arm (6) | gripper (1)].

Counterpart of `robogym_tpu/robot/composite.py`; every state tensor
carries a leading env axis `(B, ...)`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from robogym_torch.mjcf.model import Data, Model
from robogym_torch.robot import gripper as gripper_lib
from robogym_torch.robot import ur16e as arm_lib


class ControlMode:
    """(robot_interface.py:9-19)."""

    TCP_WRIST = "tcp+wrist"
    TCP_ROLL_YAW = "tcp+roll+yaw"
    JOINT = "joint"


class TcpSolverMode:
    """(robot_interface.py:22-29)."""

    MOCAP = "mocap"
    MOCAP_IK = "mocap_ik"


@dataclasses.dataclass(frozen=True)
class RobotControlParameters:
    """(robot_interface.py:33-128); the default is TCP control (xyz, roll
    and yaw) through the mocap_ik dual sim."""

    MOCAP_DEFAULT_MAX_POSITION_CHANGE = 0.05
    MOCAP_RESET_DEFAULT_MAX_POSITION_CHANGE = 0.1
    JOINT_CONTROL_DEFAULT_MAX_POSITION_CHANGE = 2.4

    control_mode: str = ControlMode.TCP_ROLL_YAW
    max_position_change: Optional[float] = None
    tcp_solver_mode: str = TcpSolverMode.MOCAP_IK
    arm_joint_calibration_path: str = "cascaded_pi"
    arm_reset_controller_error: bool = True
    use_force_limiter: bool = True
    enable_gripper_regrasp: bool = False

    def is_joint_actuated(self) -> bool:
        return (self.control_mode == ControlMode.JOINT
                or self.tcp_solver_mode == TcpSolverMode.MOCAP_IK)

    def is_tcp_controlled(self) -> bool:
        return self.control_mode in (ControlMode.TCP_WRIST, ControlMode.TCP_ROLL_YAW)

    def requires_solver_sim(self) -> bool:
        return self.is_joint_actuated() and self.is_tcp_controlled()

    def action_dims(self) -> int:
        """Composite action dims: the arm's and 1 for the gripper."""
        if self.control_mode == ControlMode.JOINT:
            return 6 + 1
        if self.control_mode == ControlMode.TCP_WRIST:
            return 4 + 1
        return 5 + 1

    def default_max_position_change(self) -> float:
        """(robot_interface.py:102-128)."""
        if self.max_position_change is not None:
            return self.max_position_change
        if self.control_mode == ControlMode.JOINT:
            return self.JOINT_CONTROL_DEFAULT_MAX_POSITION_CHANGE
        if self.tcp_solver_mode == TcpSolverMode.MOCAP:
            return self.MOCAP_DEFAULT_MAX_POSITION_CHANGE
        if self.arm_reset_controller_error:
            return self.MOCAP_RESET_DEFAULT_MAX_POSITION_CHANGE
        return self.MOCAP_DEFAULT_MAX_POSITION_CHANGE


@dataclasses.dataclass(frozen=True)
class CompositeIndex:
    arm: arm_lib.ArmIndex
    gripper: gripper_lib.GripperIndex
    params: RobotControlParameters

    @classmethod
    def build(cls, model: Model, params: RobotControlParameters,
              prefix: str = "robot0:") -> "CompositeIndex":
        return cls(arm=arm_lib.ArmIndex.build(model, prefix),
                   gripper=gripper_lib.GripperIndex.build(model, prefix), params=params)

    @property
    def action_size(self) -> int:
        return self.params.action_dims()


def set_position_control_joint(idx: CompositeIndex, m: Model, d: Data, action: torch.Tensor,
                               relative_action: bool = True) -> torch.Tensor:
    """Joint control: actions (B, 7) split [arm (6) | gripper (1)]
    (composite_robot.py:98-107); returns the whole ctrl (B, nu)."""
    ctrl = arm_lib.denormalize_position_control(
        idx.arm, m, d, action[:, :6], relative_action=relative_action,
        max_position_change=idx.params.default_max_position_change())
    return gripper_lib.denormalize_position_control(idx.gripper, m, d.replace(ctrl=ctrl),
                                                    action[:, 6:7],
                                                    relative_action=relative_action)
