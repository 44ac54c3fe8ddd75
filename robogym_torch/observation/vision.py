"""The raycast-rendered vision observation providers, batched.

Counterpart of `robogym_tpu/observation/vision.py` (the reference's
offscreen image providers, rearrange/observation/common.py:12-95 and
observation/goal.py:46-82): images come from `render/raycast.py` for the
whole batch at once. The keys follow the rearrange env's
(common/base.py:61-63): `vision_obs` (fixed cameras), `vision_obs_mobile`
(the wrist camera), `vision_goal` (the goal state, the robot hidden).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from robogym_torch.observation.common import ObservationProvider, SyncType
from robogym_torch.render import raycast


def render_cameras(m, d, camera_names: Sequence[str], image_size: int,
                   geom_visible: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, cameras, S, S, 3) uint8, each camera's image of each env."""
    return torch.stack([raycast.render_camera(m, d, name, image_size, geom_visible)
                        for name in camera_names], dim=1)


def robot_hidden_mask(m, robot_body_prefixes: Sequence[str] = ("robot0:",)) -> torch.Tensor:
    """(ngeom,) 0 on every geom of a body whose name starts with one of the
    prefixes, 1 elsewhere: the goal images' `hide_robot`
    (observation/goal.py:66-82)."""
    hidden = {bid for name, bid in m.const.names["body"].items()
              if any(name.startswith(p) for p in robot_body_prefixes)}
    vis = [0.0 if int(b) in hidden else 1.0 for b in np.asarray(m.const.geom_bodyid)]
    return torch.tensor(vis, dtype=m.dtype, device=m.device)


def make_vision_provider(camera_names: Sequence[str], image_size: int,
                         key: str = "vision_obs") -> ObservationProvider:
    """The cameras' images of the live state, read every step."""

    def read(env, state):
        from robogym_torch.envs import core as env_core

        m = env_core.apply_model_fields(env.model, state.model_fields)
        return {key: render_cameras(m, state.physics, camera_names, image_size)}

    return ObservationProvider(name=key, read=read, sync_type=SyncType.STEP)


def make_goal_vision_provider(camera_names: Sequence[str], image_size: int, goal_qpos_fn,
                              hide_robot: bool = True,
                              robot_body_prefixes: Sequence[str] = ("robot0:",),
                              key: str = "vision_goal") -> ObservationProvider:
    """The goal state's images at each goal reset: qpos set to
    `goal_qpos_fn(env, state)` (B, nq), positioned, rendered with the robot
    hidden (MujocoGoalImageObservationProvider, observation/common.py:
    52-108)."""

    def read(env, state):
        from robogym_torch.envs import core as env_core
        from robogym_torch.physics import step as physics

        m = env_core.apply_model_fields(env.model, state.model_fields)
        d_goal = physics.fwd_position(m, state.physics.replace(qpos=goal_qpos_fn(env, state)))
        vis = robot_hidden_mask(m, robot_body_prefixes) if hide_robot else None
        return {key: render_cameras(m, d_goal, camera_names, image_size, geom_visible=vis)}

    return ObservationProvider(name=key, read=read, sync_type=SyncType.RESET_GOAL)
