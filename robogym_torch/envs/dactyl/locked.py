"""The dactyl locked-cube env, batched: the Shadow Hand turns a rigid cube
to sampled axis-aligned ("parallel") orientation goals.

Counterpart of `robogym_tpu/envs/dactyl/locked.py`, with the JAX package's
semantics:
- goals: LockedParallelGoal (goals/locked_parallel.py:32-80), a uniform
  z-aligned quat times a random cube-group quat; distance =
  quat_magnitude(quat_difference(goal, cube)); success under 0.4 rad;
- episode: 50 successes needed, 400 steps a goal, a drop ends the
  episode with drop_reward (StopOnFallWrapper folded into the step);
- reset: zero-control settle, pose wiggle and uniform quat, random warmup
  steps, retries until the cube is on the palm.

`reset(batch)` and `step(state, action)` work on a batch of envs, each
tensor `(B, ...)`; where the JAX package branches per env (`lax.cond` on a
goal resample) the port selects per env with `torch.where`. Draws come
from the env's `torch.Generator`, or from the caller (`draws=`).

With `vision_observation_provider="dummy_vision"` the env adds zero images
to its observations through an `ObservationStack` (JAX `locked.py:
122-134`): `vision` read at every observe, `vision_goal` cached in the
state, `goal_aux = (inner goal_aux, cache)`, and read again only for the
envs whose goal resamples, on their post-step state with the new goal.
With `"raycast"` the same two keys are rendered images of the three vision
cameras (`render/raycast.py`, JAX `locked.py:75-120`): `vision` of the live
state with the target hidden, `vision_goal` of the cube posed at the goal
quat through `fwd_position` with the target and the hand hidden; the
cameras and lights may be jittered each episode (`camera_*_radius`,
`light_*`: `randomization/vision.py`), as per-env model fields.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from robogym_torch import bridge
from robogym_torch.envs import core
from robogym_torch.envs.dactyl import cube_env
from robogym_torch.mjcf.model import Data, Model
from robogym_torch.observation import common as obs_common
from robogym_torch.observation import dummy_vision
from robogym_torch.observation import vision as vision_lib
from robogym_torch.physics import step as physics
from robogym_torch.randomization import vision as vision_rand
from robogym_torch.robot import shadow_hand as hand
from robogym_torch.utils import rotation as rot
from robogym_torch.worlds import dactyl_locked_like


@dataclasses.dataclass(frozen=True)
class LockedEnvConstants(cube_env.DactylCubeEnvConstants):
    """(locked.py:51-68)."""

    success_threshold_cube_quat: float = 0.4
    # vision observations: "" (off), "dummy_vision" (zero images, the
    # reference's default for locked vision configs, cube_env.py:295-306)
    # or "raycast" (images rendered by render/raycast.py)
    vision_observation_provider: str = ""
    vision_image_size: int = 200
    # the raycast images' camera and light randomization
    # (randomization/vision.py)
    camera_fovy_radius: float = 0.0
    camera_pos_radius: float = 0.0
    camera_quat_radius: float = 0.0
    light_pos_range: float = 0.0
    light_diffuse_intensity: float = 0.4
    light_ambient_intensity: float = 0.1


class LockedEnv(cube_env.CubeEnvBase):
    """The locked-cube env on a batch: `reset(batch)`, `step(state, action)`."""

    def __init__(self, constants: Optional[LockedEnvConstants] = None,
                 model: Optional[Model] = None, seed: int = 0):
        constants = constants or LockedEnvConstants()
        if model is None:
            raise ValueError("LockedEnv takes a compiled model (see make_env)")
        super().__init__(constants, model, seed=seed)
        self.obs_stack = None
        if constants.vision_observation_provider == "raycast":
            cams = tuple(dummy_vision.DEFAULT_CAMERA_NAMES)
            missing = [c for c in cams if c not in model.const.names["camera"]]
            if missing:
                raise ValueError(f"the raycast provider renders cameras {missing}, which the "
                                 "model lacks (worlds/vision_like.py has them)")
            size = constants.vision_image_size
            hide_tgt = vision_lib.robot_hidden_mask(self.model, ("target:",))
            hide_all = vision_lib.robot_hidden_mask(self.model, ("target:", "robot0:"))

            def read_vision(env, state):
                m = core.apply_model_fields(env.model, state.model_fields)
                return {"vision": vision_lib.render_cameras(m, state.physics, cams, size,
                                                            geom_visible=hide_tgt)}

            def read_goal_vision(env, state):
                m = core.apply_model_fields(env.model, state.model_fields)
                return {"vision_goal": vision_lib.render_cameras(
                    m, physics.fwd_position(m, env.goal_pose(state)), cams, size,
                    geom_visible=hide_all)}

            self.obs_stack = obs_common.ObservationStack({
                "vision": obs_common.ObservationProvider(
                    name="vision", read=read_vision, sync_type=obs_common.SyncType.STEP),
                "goal_vision": obs_common.ObservationProvider(
                    name="goal_vision", read=read_goal_vision,
                    sync_type=obs_common.SyncType.RESET_GOAL),
            })
        elif constants.vision_observation_provider == "dummy_vision":
            size = constants.vision_image_size
            self.obs_stack = obs_common.ObservationStack({
                "dummy_vision": dummy_vision.make_dummy_vision_provider(image_size=size),
                "goal_dummy_vision": dummy_vision.make_dummy_goal_vision_provider(
                    image_size=size),
            })

    @property
    def vision_params(self) -> vision_rand.VisionRandomizationParams:
        cst = self.constants
        return vision_rand.VisionRandomizationParams(
            camera_fovy_radius=cst.camera_fovy_radius, camera_pos_radius=cst.camera_pos_radius,
            camera_quat_radius=cst.camera_quat_radius, light_pos_range=cst.light_pos_range,
            light_diffuse_intensity=cst.light_diffuse_intensity,
            light_ambient_intensity=cst.light_ambient_intensity)

    def _vision_active(self) -> bool:
        return bool(self.constants.vision_observation_provider) and \
            self.vision_params.any_active()

    def draw_vision(self, n: int) -> Optional[Dict[str, torch.Tensor]]:
        """The camera and light draws of n episodes, where the env
        randomizes them (`randomization/vision.py`)."""
        if not self._vision_active():
            return None
        return vision_rand.draw_vision(self.generator, n, self.model)

    def goal_pose(self, state: core.EnvState) -> Data:
        """The state with the cube turned to its goal quat (not positioned)."""
        qpos = state.physics.qpos.clone()
        qpos[:, torch.as_tensor(self.cube.cube_rot_qpos, device=qpos.device)] = \
            state.goal["cube_quat"].to(qpos.dtype)
        return state.physics.replace(qpos=qpos)

    # goals (LockedParallelGoal)
    def draw_step(self, n: int) -> Dict[str, torch.Tensor]:
        """One step's (or reset's) goal and hold draws for n envs: the
        goal's angle draw and parallel-quat choice, and the success-hold
        draw, all (n,)."""
        u, choice = cube_env.draw_parallel_goal(self.generator, n, self.dtype, self.device)
        pause = torch.rand((n,), generator=self.generator, dtype=self.dtype, device=self.device)
        return dict(goal_u=u, goal_choice=choice, pause_u=pause)

    def _next_goal(self, draws: Dict[str, torch.Tensor],
                   prev_goal: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, torch.Tensor]:
        """A new goal for every env from `draws`; `prev_goal` the goal it
        replaces (None at a reset)."""
        return {"cube_quat": cube_env.sample_parallel_goal_quat(draws["goal_u"],
                                                                draws["goal_choice"])}

    def _goal_distance(self, goal, d: Data) -> Dict[str, torch.Tensor]:
        rel = rot.quat_difference(goal["cube_quat"], cube_env.cube_quat(self.cube, d))
        return {"cube_quat": rot.quat_magnitude(rel)}

    @property
    def _thresholds(self) -> Dict[str, float]:
        return {"cube_quat": self.constants.success_threshold_cube_quat}

    # env API
    def reset(self, batch: int, attempts: Optional[List[Dict[str, torch.Tensor]]] = None,
              draws: Optional[Dict[str, torch.Tensor]] = None,
              vision_draws: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[core.EnvState, Dict[str, torch.Tensor]]:
        """`batch` new episodes: (state, obs). `attempts` are the reset
        attempts' draws (`CubeEnvBase.reset_physics`), `draws` the goal's
        and hold's (`draw_step`), `vision_draws` the cameras' and lights'
        (`draw_vision`); by default each comes from the env's generator."""
        d = self.reset_physics(batch, attempts)
        draws = draws if draws is not None else self.draw_step(batch)
        vision_draws = vision_draws if vision_draws is not None else self.draw_vision(batch)
        fields = (vision_rand.apply_vision(self.model, vision_draws, self.vision_params)
                  if vision_draws is not None and self._vision_active() else None)
        goal = self._next_goal(draws)
        tracker = core.TrackerState.zero(batch, device=self.device).replace(
            success_steps_required=core.sample_success_steps_required(draws["pause_u"],
                                                                      self.constants))
        goal_aux = torch.zeros(batch, dtype=self.dtype, device=self.device)
        state = core.EnvState(
            physics=d, goal=goal, goal_aux=goal_aux,
            prev_goal_distance=self._goal_distance(goal, d), tracker=tracker,
            t=torch.zeros(batch, dtype=torch.int32, device=self.device), model_fields=fields)
        if self.obs_stack is not None:
            # the RESET sync reads the cached providers; the cache rides in goal_aux
            cache = self.obs_stack.sync(self, state, None, obs_common.SyncType.RESET)
            state = state.replace(goal_aux=(goal_aux, cache))
        return state, self._observe(state)

    def step(self, state: core.EnvState, action: torch.Tensor,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        """One env step of `mujoco_substeps` physics substeps for the batch:
        (state, obs, reward (B, 3), done (B,), info). `action` (B, 20) in
        [-1, 1]; `draws` as `draw_step` gives them (by default from the
        env's generator), used where an env's goal resamples."""
        cst = self.constants
        m = core.apply_model_fields(self.model, state.model_fields)
        action = torch.clamp(action, -1.0, 1.0).to(self.dtype)
        d = state.physics
        ctrl = hand.denormalize_position_control(self.hand, m, d, action,
                                                 relative_action=cst.relative_action,
                                                 max_position_change=cst.max_position_change)
        d = physics.step_n(m, d.replace(ctrl=ctrl), cst.mujoco_substeps)
        d, crashed = core.divergence_guard(state.physics, d)

        dist = self._goal_distance(state.goal, d)
        goal_distance_reward = (core.goal_distance_sum(state.prev_goal_distance)
                                - core.goal_distance_sum(dist))
        successful = core.is_successful(dist, self._thresholds)
        tracker, success_reward, done, need_new_goal = core.tracker_process(
            state.tracker, cst, successful, torch.zeros_like(successful))

        # StopOnFallWrapper (wrappers/cube.py:106-150): a drop ends the episode
        env_reward = torch.zeros_like(goal_distance_reward)
        if cst.stop_on_fall:
            fallen = ~cube_env.is_on_palm(self.cube, d)
            done = done | fallen
            env_reward = torch.where(fallen, cst.drop_reward, 0.0).to(self.dtype)

        draws = draws if draws is not None else self.draw_step(d.qpos.shape[0])
        new = self._next_goal(draws, state.goal)
        goal = {k: torch.where(need_new_goal.reshape((-1,) + (1,) * (v.dim() - 1)), new[k], v)
                for k, v in state.goal.items()}
        succ_req = torch.where(need_new_goal,
                               core.sample_success_steps_required(draws["pause_u"], cst),
                               tracker.success_steps_required)
        tracker = tracker.replace(
            success_steps_required=succ_req,
            consecutive_successes=torch.where(need_new_goal,
                                              torch.zeros_like(tracker.consecutive_successes),
                                              tracker.consecutive_successes))
        resampled = self._goal_distance(goal, d)
        dist_after = {k: torch.where(need_new_goal, resampled[k], v) for k, v in dist.items()}
        goal_aux = state.goal_aux
        if self.obs_stack is not None:
            # the RESET_GOAL providers are read again for the envs that
            # resample only, on the post-step state with the new goal;
            # elsewhere the cache carries over, uncopied
            inner_aux, cache = goal_aux
            envs = torch.nonzero(need_new_goal).flatten()
            if envs.numel():
                synced = core.take_envs(state.replace(physics=d, goal=goal), envs)
                cache = self.obs_stack.sync(self, synced, cache, obs_common.SyncType.RESET_GOAL,
                                            envs=envs)
            goal_aux = (inner_aux, cache)
        new_state = core.EnvState(physics=d, goal=goal, goal_aux=goal_aux,
                                  prev_goal_distance=dist_after, tracker=tracker,
                                  t=state.t + 1, model_fields=state.model_fields)
        reward = torch.stack([env_reward, goal_distance_reward.to(self.dtype),
                              success_reward.to(self.dtype)], dim=-1)
        done = done | crashed
        info = {"goal_dist": dist["cube_quat"], "is_successful": successful,
                "env_crash": crashed}
        info.update(core.tracker_info(tracker, cst))
        return new_state, self._observe(new_state), reward, done, info

    def _observe(self, state: core.EnvState) -> Dict[str, torch.Tensor]:
        """The default observation map (locked.py:133-147)."""
        d = state.physics
        B = d.qpos.shape[0]
        dist = self._goal_distance(state.goal, d)
        if self.constants.relative_fingertips:
            tips = cube_env.relative_fingertip_positions(self.hand, self.model, d)
        else:
            tips = hand.fingertip_positions(self.hand, d)
        obs = {
            "cube_pos": cube_env.cube_pos(self.cube, d),
            "cube_quat": cube_env.cube_quat(self.cube, d),
            "qpos": d.qpos,
            "qvel": d.qvel,
            "hand_angle": hand.joint_positions(self.hand, d),
            "fingertip_pos": tips,
            "goal_pos": torch.zeros((B, 3), dtype=self.dtype, device=self.device),
            "goal_quat": state.goal["cube_quat"],
            "is_goal_achieved": core.is_successful(dist, self._thresholds)[:, None].to(self.dtype),
        }
        if self.obs_stack is not None:
            # STEP providers are read now; the others come from the cache
            # (robot_env.py:273-301)
            _, cache = state.goal_aux
            for name, p in self.obs_stack.providers.items():
                obs.update(p.read(self, state) if p.sync_type == obs_common.SyncType.STEP
                           else cache[name])
        return obs


def make_env(constants: Optional[dict] = None, device="cuda", seed: int = 0,
             model: Optional[Model] = None,
             snapshot: str = dactyl_locked_like.SNAPSHOT) -> LockedEnv:
    """The locked env on `device` (the card unless the caller asks for the
    CPU), on `model` (for example `cube_env.compile_world`'s composed
    world) or else the compiled world `snapshot` (the dactyl-shaped
    stand-in by default), its draws seeded by `seed`."""
    if model is None:
        with np.load(snapshot) as z:
            model = bridge.model_from_numpy({k: z[k] for k in z.files}, device)
    return LockedEnv(LockedEnvConstants(**(constants or {})), model, seed=seed)
