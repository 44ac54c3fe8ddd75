"""The Robotiq 2f-85 gripper, batched: name tables, one-dof position
control of the finger linkage through `robot0:r_gripper_finger_joint`,
and the regrasp (anti-backdrive) state machine.

Counterpart of `robogym_tpu/robot/gripper.py`; every state tensor carries
a leading env axis `(B, ...)`, and `RegraspState`'s fields are `(B,)`.
"""

from __future__ import annotations

import dataclasses

import torch

from robogym_torch.mjcf.model import Data, Model

JOINTS = ["r_gripper_RJ0_outer"]


@dataclasses.dataclass(frozen=True)
class GripperIndex:
    prefix: str
    actuator_id: int
    joint_qpos_id: int
    joint_dof_id: int

    @classmethod
    def build(cls, model: Model, prefix: str = "robot0:") -> "GripperIndex":
        c = model.const
        jid = c.names["joint"][prefix + JOINTS[0]]
        return cls(
            prefix=prefix,
            actuator_id=int(c.names["actuator"][prefix + "r_gripper_finger_joint"]),
            joint_qpos_id=int(c.jnt_qposadr[jid]),
            joint_dof_id=int(c.jnt_dofadr[jid]),
        )


def joint_position(idx: GripperIndex, d: Data) -> torch.Tensor:
    return d.qpos[:, idx.joint_qpos_id][:, None]


def joint_velocity(idx: GripperIndex, d: Data) -> torch.Tensor:
    return d.qvel[:, idx.joint_dof_id][:, None]


def denormalize_position_control(idx: GripperIndex, m: Model, d: Data,
                                 position_control: torch.Tensor,
                                 relative_action: bool = True) -> torch.Tensor:
    """Actions (B, 1) in [-1, 1] -> the whole ctrl (B, nu) with the finger
    target written (robot_interface.py:247-278; no max_position_change,
    mujoco_robotiq_gripper.py:70-72)."""
    ids = torch.tensor([idx.actuator_id], device=d.ctrl.device)
    cr = m.take("actuator_ctrlrange", ids)[..., 0, :]
    lo, hi = cr[..., 0], cr[..., 1]
    center = d.qpos[:, idx.joint_qpos_id] if relative_action else (hi + lo) / 2.0
    ctrl = d.ctrl.clone()
    ctrl[:, idx.actuator_id] = torch.minimum(
        torch.maximum(center + position_control[:, 0] * (hi - lo) / 2.0, lo), hi)
    return ctrl


# The regrasp heuristic (regrasp_helper.py:82-255) as the JAX package
# encodes it: last_cmd_dir / last_obs_dir hold 0.0 for the reference's None;
# prev and second_prev action start at the initial hold control.

@dataclasses.dataclass(frozen=True)
class RegraspState:
    regrasp_cmd: torch.Tensor         # (B,) command re-issued while active
    regrasp_active: torch.Tensor      # (B,) bool
    prev_obs_position: torch.Tensor   # (B,) last observed joint position
    last_cmd_dir: torch.Tensor        # (B,) in {0, +1, -1}; 0 is None
    last_obs_dir: torch.Tensor        # (B,) in {0, +1, -1}; 0 is None
    prev_action: torch.Tensor         # (B,) last returned control
    second_prev_action: torch.Tensor  # (B,) second-to-last returned control


def init_regrasp(initial_position: torch.Tensor, initial_control: torch.Tensor) -> RegraspState:
    """A fresh per-episode regrasp state (regrasp_helper.py:14-22) from
    (B,) joint positions and controls."""
    p, c = initial_position.reshape(-1), initial_control.reshape(-1)
    zero = torch.zeros_like(p)
    return RegraspState(regrasp_cmd=c, regrasp_active=torch.zeros_like(p, dtype=torch.bool),
                        prev_obs_position=p, last_cmd_dir=zero, last_obs_dir=zero,
                        prev_action=c, second_prev_action=c)


def _sign_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.abs(x) < 1e-5, torch.zeros_like(x), torch.sign(x))


def compute_regrasp_control(s: RegraspState, position_control: torch.Tensor,
                            default_control: torch.Tensor, current_position: torch.Tensor):
    """RegraspHelper.compute_regrasp_control for the batch, each argument
    (B,): (control (B,), new state), the JAX package's selects:
      bypass  - active and the user keeps: re-issue regrasp_cmd, no state
                update;
      trigger - close or keep, the last command closed, the gripper was
                closing or still and now opens: regrasp with the
                second-to-last action;
      active  - max(regrasp_cmd, default), else the default control."""
    pc, default, pos = position_control, default_control, current_position
    obs_dir = _sign_or_zero(pos - s.prev_obs_position)
    wants_open, wants_close, wants_keep = pc < 0.0, pc > 0.0, pc == 0.0
    active = s.regrasp_active & ~wants_open
    bypass = s.regrasp_active & ~wants_open & ~wants_close
    trigger = ((wants_close | wants_keep) & (s.last_cmd_dir > 0.0) & (s.last_obs_dir > 0.0)
               & (obs_dir < 0.0) & ~bypass)
    regrasp_cmd = torch.where(trigger, s.second_prev_action, s.regrasp_cmd)
    active = active | trigger
    regrasp_cmd = torch.where(active & (default > regrasp_cmd), default, regrasp_cmd)
    out = torch.where(active, regrasp_cmd, default)
    out = torch.where(bypass, s.regrasp_cmd, out)
    new_last_obs = torch.where(obs_dir != 0.0, obs_dir, s.last_obs_dir)

    def upd(new, old):
        return torch.where(bypass, old, new)

    new_state = RegraspState(
        regrasp_cmd=upd(regrasp_cmd, s.regrasp_cmd),
        regrasp_active=upd(active, s.regrasp_active),
        prev_obs_position=upd(pos, s.prev_obs_position),
        last_cmd_dir=upd(_sign_or_zero(pc), s.last_cmd_dir),
        last_obs_dir=upd(new_last_obs, s.last_obs_dir),
        prev_action=upd(out, s.prev_action),
        second_prev_action=upd(s.prev_action, s.second_prev_action),
    )
    return out, new_state
