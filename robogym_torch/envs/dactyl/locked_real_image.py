"""The dactyl locked-cube env whose goals come from a fixed pool of (quat,
image) pairs, batched.

Counterpart of `robogym_tpu/envs/dactyl/locked_real_image.py` (the
reference's LockedRealImageGoal, envs/dactyl/goals/locked_real_image.py:
9-41). The reference reads goal images captured on the real rig from an
npz (`goal_data_path`: "quats" (N, 4) and one (N, S, S, 3) image array per
camera of `dummy_vision.DEFAULT_CAMERA_NAMES`); with no such file the pool
is rendered from the simulation: `goal_pool_size` goal quats drawn once,
the cube of the settled start state turned to each and rendered by the
three vision cameras with the hand and the target hidden (the goal images'
convention). Goals are taken from the pool in turn (`goal_idx`, wrapping),
and the pooled image is the `vision_goal` observation, at each goal reset.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from robogym_torch import bridge
from robogym_torch.envs import core
from robogym_torch.envs.dactyl import cube_env
from robogym_torch.envs.dactyl.locked import LockedEnv, LockedEnvConstants
from robogym_torch.mjcf.model import Model
from robogym_torch.observation import common as obs_common
from robogym_torch.observation import dummy_vision
from robogym_torch.observation import vision as vision_lib
from robogym_torch.physics import step as physics
from robogym_torch.worlds import vision_like

POOL_SEED = 17                   # the seed of the sim-rendered pool's goal draws


@dataclasses.dataclass(frozen=True)
class LockedRealImageEnvConstants(LockedEnvConstants):
    goal_generation: str = "real_image"
    vision_observation_provider: str = "raycast"
    # an npz of the reference's format; empty: the pool is rendered
    goal_data_path: str = ""
    goal_pool_size: int = 16


class LockedRealImageEnv(LockedEnv):
    """The locked env whose goals iterate a fixed (quat, image) pool.
    `pool_draws` (u, choice), each (goal_pool_size,), are the rendered
    pool's goal draws (`cube_env.draw_parallel_goal`; by default from a
    generator seeded with POOL_SEED)."""

    def __init__(self, constants: Optional[LockedRealImageEnvConstants] = None,
                 model: Optional[Model] = None, seed: int = 0,
                 pool_draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        cst = constants or LockedRealImageEnvConstants()
        super().__init__(cst, model, seed=seed)
        if cst.goal_data_path:
            with np.load(cst.goal_data_path) as data:
                quats = torch.as_tensor(np.asarray(data["quats"], np.float64), dtype=self.dtype,
                                        device=self.device)
                # (N, cameras, S, S, 3): each goal's images, camera by camera
                imgs = torch.as_tensor(np.stack([np.asarray(data[c]) for c in
                                                 dummy_vision.DEFAULT_CAMERA_NAMES], axis=1),
                                       device=self.device)
        else:
            quats, imgs = self._render_sim_pool(cst.goal_pool_size, pool_draws)
        self.pool_quats, self.pool_images = quats, imgs
        if self.obs_stack is not None:
            # the pooled image, not a render of the goal pose
            providers = dict(self.obs_stack.providers)
            providers["goal_vision"] = obs_common.ObservationProvider(
                name="goal_vision",
                read=lambda env, state: {"vision_goal": state.goal["vision_goal"]},
                sync_type=obs_common.SyncType.RESET_GOAL)
            self.obs_stack = obs_common.ObservationStack(providers)

    def _render_sim_pool(self, n: int, draws=None):
        """n goal quats and their images: the settled start state's cube
        turned to each, positioned, rendered with the hand and the target
        hidden."""
        if draws is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(POOL_SEED)
            draws = cube_env.draw_parallel_goal(gen, n, self.dtype, self.device)
        quats = cube_env.sample_parallel_goal_quat(*draws)
        d = core.data_map(lambda x: x.expand((n,) + x.shape[1:]).clone(), self._settled_data)
        qpos = d.qpos.clone()
        qpos[:, torch.as_tensor(self.cube.cube_rot_qpos, device=self.device)] = quats
        d = physics.fwd_position(self.model, d.replace(qpos=qpos))
        hide = vision_lib.robot_hidden_mask(self.model, ("target:", "robot0:"))
        imgs = vision_lib.render_cameras(self.model, d, dummy_vision.DEFAULT_CAMERA_NAMES,
                                         self.constants.vision_image_size, geom_visible=hide)
        return quats, imgs

    def _next_goal(self, draws: Dict[str, torch.Tensor],
                   prev_goal: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """The pool's first goal at a reset, else the one after `prev_goal`'s
        (wrapping)."""
        n = self.pool_quats.shape[0]
        B = draws["pause_u"].shape[0]
        if prev_goal is None:
            idx = torch.zeros(B, dtype=torch.long, device=self.device)
        else:
            idx = (prev_goal["goal_idx"] + 1) % n
        return {"cube_quat": self.pool_quats[idx], "vision_goal": self.pool_images[idx],
                "goal_idx": idx}


def make_env(constants: Optional[dict] = None, device="cuda", seed: int = 0,
             model: Optional[Model] = None,
             snapshot: str = vision_like.DACTYL_SNAPSHOT) -> LockedRealImageEnv:
    """The real-image locked env on `device` (the card unless the caller
    asks for the CPU), on `model` (for example `cube_env.compile_world`'s
    composed world, which carries the vision cameras under "raycast") or
    else the compiled world `snapshot` (the dactyl-shaped stand-in with the
    vision cameras by default), its draws seeded by `seed`."""
    if model is None:
        with np.load(snapshot) as z:
            model = bridge.model_from_numpy({k: z[k] for k in z.files}, device)
    return LockedRealImageEnv(LockedRealImageEnvConstants(**(constants or {})), model, seed=seed)
