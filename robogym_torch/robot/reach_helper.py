"""Reach helper: drive a robot arm to target joint positions from the host.

Counterpart of `robogym_tpu/robot/reach_helper.py` (the original robogym's
blocking reach loop): each step commands a position delta toward the
target, limited by `max_speed_per_sec`, and an env has reached when every
joint is within `reached_position_threshold` of its target and slower than
`stopped_velocity_threshold` for `stopped_stable_steps` steps in a row.

The port's env steps a batch: `reach_position` drives every env of a
batched state at once, each to its own target, and stops when every env
has reached or at the timeout. An env that has reached keeps the state it
reached in (the batch steps on for the others), as the JAX loop returns
at that step; `ReachResult`'s fields carry a leading env axis, and B=1 is
the JAX package's case.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from robogym_torch.envs import core
from robogym_torch.robot import ur16e as arm_lib


class MeasurementUnit:
    RADIANS = "radians"
    METERS = "meters"


@dataclasses.dataclass
class ReachResult:
    """Per env: whether it reached and stopped, the steps it took (the
    timeout where it did not), its joint positions then and their error
    from the target."""

    reached: np.ndarray          # (B,) bool
    steps: np.ndarray            # (B,) int
    final_position: np.ndarray   # (B, joints)
    final_error: np.ndarray      # (B, joints)

    def reached_position_and_stopped(self) -> np.ndarray:
        return self.reached


# defaults per measurement unit (the original robogym's reach_helper.py)
_DEFAULTS = {
    MeasurementUnit.RADIANS: dict(
        reached_position_threshold=np.deg2rad(1.0),
        stopped_velocity_threshold=np.deg2rad(1.0),
        max_speed_per_sec=np.deg2rad(30.0),
    ),
    MeasurementUnit.METERS: dict(
        reached_position_threshold=0.005,
        stopped_velocity_threshold=0.001,
        max_speed_per_sec=0.025,
    ),
}


def _where(mask: torch.Tensor, a, b):
    """Per env, tree `a` where `mask` (B,) holds, else `b` (an env
    state's tensors with an env axis; any other leaf from `a`)."""
    if isinstance(a, torch.Tensor):
        if a.dim() == 0 or a.shape[0] != mask.shape[0]:
            return a
        return torch.where(mask.view((-1,) + (1,) * (a.dim() - 1)), a, b)
    if isinstance(a, core.Data):
        return core.data_where(mask, a, b)
    if isinstance(a, dict):
        return {k: _where(mask, v, b[k]) for k, v in a.items()}
    if isinstance(a, (tuple, list)):
        return type(a)(_where(mask, x, y) for x, y in zip(a, b))
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{f.name: _where(mask, getattr(a, f.name),
                                                        getattr(b, f.name))
                                         for f in dataclasses.fields(a)})
    return a


def reach_position(
    env,
    state,
    position_control,
    *,
    timeout_steps: int = 200,
    speed_units_per_sec: Optional[float] = None,
    position_threshold: Optional[float] = None,
    measurement_unit: str = MeasurementUnit.RADIANS,
    stopped_stable_steps: int = 5,
):
    """Drive `env` (JOINT control mode) from the batched `state` to the
    target joint positions `position_control`, (joints,) for every env or
    (B, joints) each env's own. Returns (new state, ReachResult).

    The action at each step commands a clipped delta toward the target,
    clip(err, -speed dt, speed dt) / max_position_change, in float64 and
    then the env's dtype, as the JAX loop computes it."""
    defaults = _DEFAULTS[measurement_unit]
    speed = (speed_units_per_sec if speed_units_per_sec is not None
             else defaults["max_speed_per_sec"])
    thr = (position_threshold if position_threshold is not None
           else defaults["reached_position_threshold"])
    vel_thr = defaults["stopped_velocity_threshold"]
    max_delta = speed * env.constants.step_duration

    rcp = env.parameters.robot_control_params
    assert rcp.control_mode == "joint", (
        "reach_position drives the joint control mode; TCP flows use the "
        "teleop controller"
    )
    max_change = rcp.default_max_position_change()
    arm = env.robot.arm
    B, dev = state.t.shape[0], state.t.device
    target = torch.as_tensor(np.asarray(position_control, np.float64), device=dev)
    target = target.expand(B, -1) if target.dim() == 1 else target

    def read(st):
        cur = arm_lib.joint_positions(arm, st.physics)
        return cur, target - cur.double(), arm_lib.joint_velocities(arm, st.physics).double()

    stable = torch.zeros(B, dtype=torch.long, device=dev)
    done = torch.zeros(B, dtype=torch.bool, device=dev)
    steps = torch.full((B,), timeout_steps, dtype=torch.long, device=dev)
    final = state
    cur, err, vel = read(state)
    pos, pos_err = cur.clone(), err.clone()
    for t in range(timeout_steps):
        ok = (err.abs() < thr).all(-1) & (vel.abs() < vel_thr).all(-1)
        stable = torch.where(ok, stable + 1, torch.zeros_like(stable))
        now = ~done & (stable >= stopped_stable_steps)
        if bool(now.any()):
            steps = torch.where(now, t, steps)
            pos = torch.where(now[:, None], cur, pos)
            pos_err = torch.where(now[:, None], err, pos_err)
            final = _where(now, state, final)
            done = done | now
            if bool(done.all()):
                break
        delta = torch.clamp(err, -max_delta, max_delta)
        action = torch.zeros((B, env.action_size), dtype=torch.float64, device=dev)
        action[:, :6] = torch.clamp(delta / max_change, -1.0, 1.0)
        state, _, _, _, _ = env.step(state, action.to(env.dtype))
        cur, err, vel = read(state)
    pos = torch.where(done[:, None], pos, cur)
    pos_err = torch.where(done[:, None], pos_err, err)
    final = _where(done, final, state)
    return final, ReachResult(done.cpu().numpy(), steps.cpu().numpy(), pos.cpu().numpy(),
                              pos_err.cpu().numpy())
