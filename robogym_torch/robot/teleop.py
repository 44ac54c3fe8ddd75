"""Teleop controller: human commands -> env actions.

Counterpart of `robogym_tpu/robot/teleop.py` (the URGripperArmController of
the original robogym): discrete move commands become relative TCP, wrist
and gripper actions in [-1, 1], with adjustable speeds (speed_up and
speed_down scale them by 20 %). Host-side numpy only: one action vector a
command, which a caller broadcasts over its batch of envs."""

from __future__ import annotations

import numpy as np


class Direction:
    POS = 1
    NEG = -1


class URGripperArmController:
    """Action layout (TCP modes): [x, y, z, (roll,) yaw/wrist, gripper]."""

    MAX_SPEED = 1.0
    MIN_SPEED = 0.0
    SPEED_CHANGE_PERCENT = 0.2

    def __init__(self, env):
        # [arm_speed, wrist_speed, gripper_speed]
        self._speeds = np.array([0.3, 0.5, 0.3])
        self.env = env
        self.action_size = env.action_size

    @property
    def arm_speed(self):
        return self._speeds[0]

    @property
    def wrist_speed(self):
        return self._speeds[1]

    @property
    def gripper_speed(self):
        return self._speeds[2]

    def zero_control(self) -> np.ndarray:
        return np.zeros(self.action_size)

    def speed_up(self):
        self._speeds = np.minimum(
            self._speeds * (1 + self.SPEED_CHANGE_PERCENT), self.MAX_SPEED
        )

    def speed_down(self):
        self._speeds = np.maximum(
            self._speeds * (1 - self.SPEED_CHANGE_PERCENT), self.MIN_SPEED
        )

    def _move(self, dim: int, direction: int, speed: float) -> np.ndarray:
        a = self.zero_control()
        a[dim] = direction * speed
        return a

    def move_x(self, direction: int) -> np.ndarray:
        return self._move(0, direction, self.arm_speed)

    def move_y(self, direction: int) -> np.ndarray:
        return self._move(1, direction, self.arm_speed)

    def move_z(self, direction: int) -> np.ndarray:
        return self._move(2, direction, self.arm_speed)

    def rotate_wrist(self, direction: int) -> np.ndarray:
        # wrist/yaw is the last arm dim before the gripper
        return self._move(self.action_size - 2, direction, self.wrist_speed)

    def move_gripper(self, direction: int) -> np.ndarray:
        return self._move(self.action_size - 1, direction, self.gripper_speed)

    def tilt_gripper(self, direction: int) -> np.ndarray:
        """The roll dim, present only in tcp+roll+yaw's 6-dim action
        layout."""
        if self.action_size >= 6:
            return self._move(3, direction, self.wrist_speed)
        return self.zero_control()

    # keyboard map (the original robogym's viewer/robot_control_viewer.py)
    KEYMAP = {
        "up": ("move_x", Direction.POS),
        "down": ("move_x", Direction.NEG),
        "left": ("move_y", Direction.POS),
        "right": ("move_y", Direction.NEG),
        "z+": ("move_z", Direction.POS),
        "z-": ("move_z", Direction.NEG),
        "wrist+": ("rotate_wrist", Direction.POS),
        "wrist-": ("rotate_wrist", Direction.NEG),
        "grip+": ("move_gripper", Direction.POS),
        "grip-": ("move_gripper", Direction.NEG),
    }

    def action_for(self, command: str) -> np.ndarray:
        """Map a named command (see KEYMAP) to an action vector."""
        if command in ("+", "speed_up"):
            self.speed_up()
            return self.zero_control()
        if command in ("-", "speed_down"):
            self.speed_down()
            return self.zero_control()
        method, direction = self.KEYMAP[command]
        return getattr(self, method)(direction)
