"""The dactyl reach env, batched: the Shadow Hand moves its five fingertips
to sampled positions.

Counterpart of `robogym_tpu/envs/dactyl/reach.py`, with the JAX package's
semantics:
- goals: FingertipPosGoal (shadow_hand_reach_fingertip_pos.py), a
  joint-space sample around the previous goal (0.1 of each joint's range
  times a normal draw), clipped to the joint ranges, made feasible in a
  goal sim from the settled start: `goal_stabilize_steps` env steps of
  substeps under a relative zero action, or `fwd_position` where that is
  0; the goal is the goal sim's fingertip positions;
- success when the fingertips' distance (one norm over all 15
  coordinates) is under 2.5 cm; 50 successes needed, 150 steps a goal;
- construction settles one env for 20 env steps under centred control.

`reset(batch)` and `step(state, action)` work on a batch of envs, each
tensor `(B, ...)`. Draws come from the env's `torch.Generator`, or from the
caller (`draws=`). `goal_aux` carries each env's goal joint positions
(B, 24), the centre of its next goal sample.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from robogym_torch import bridge
from robogym_torch.envs import core
from robogym_torch.mjcf.model import Data, Model, make_data
from robogym_torch.physics import step as physics
from robogym_torch.robot import shadow_hand as hand
from robogym_torch.worlds import dactyl_reach_like


@dataclasses.dataclass(frozen=True)
class ReachEnvConstants(core.EnvConstants):
    """(reference reach.py:44-56)."""

    success_threshold: float = 0.025
    successes_needed: int = 50
    max_timesteps_per_goal: int = 150
    # env steps of the goal sim that makes a sampled goal feasible
    # (shadow_hand_reach_fingertip_pos.py:56-66); 0: the goal's forward
    # kinematics only
    goal_stabilize_steps: int = 2
    success_pause_range_s: Tuple[float, float] = (0.0, 0.5)


class ReachEnv:
    """The reach env on a batch: `reset(batch)`, `step(state, action)`."""

    def __init__(self, constants: Optional[ReachEnvConstants] = None,
                 model: Optional[Model] = None, seed: int = 0):
        if model is None:
            raise ValueError("ReachEnv takes a compiled model (see make_env)")
        self.constants = cst = constants or ReachEnvConstants()
        dev, dtype = model.device, model.dtype
        model = model.replace(opt=dataclasses.replace(
            model.opt, timestep=torch.tensor(cst.mujoco_timestep, dtype=dtype, device=dev)))
        self.model = model
        self.hand = hand.HandIndex.build(model)
        self.action_size = 20
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        # goal sims run, and envs they ran on (`_next_goal`)
        self.goal_sims = 0
        self.goal_sim_envs = 0

        # the settled start (reach.py:128-135): 20 env steps of centred
        # control, on one env
        d0 = make_data(model, 1)
        ctrl0 = hand.denormalize_position_control(self.hand, model, d0,
                                                  hand.zero_control(1, dtype, dev),
                                                  relative_action=False)
        d0 = physics.step_n(model, d0.replace(ctrl=ctrl0), 20 * cst.mujoco_substeps)
        self._initial_data = d0.replace(time=torch.zeros_like(d0.time))
        jr = model.jnt_range[torch.as_tensor(self.hand.joint_ids, device=dev)]
        self._goal_lo, self._goal_hi = jr[:, 0], jr[:, 1]

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    def _initial(self, n: int) -> Data:
        """The settled start, broadcast to n envs."""
        return core.data_map(lambda x: x.expand((n,) + x.shape[1:]).clone(), self._initial_data)

    # goals (FingertipPosGoal)
    def draw_step(self, n: int) -> Dict[str, torch.Tensor]:
        """One step's (or reset's) draws for n envs: the goal sample's
        normal draws (n, 24) and the success-hold draw (n,) uniform in
        [0, 1)."""
        g, dev, dt = self.generator, self.device, self.dtype
        return dict(goal_noise=torch.randn((n, 24), generator=g, dtype=dt, device=dev),
                    pause_u=torch.rand((n,), generator=g, dtype=dt, device=dev))

    def _next_goal(self, noise: torch.Tensor, goal_joint_pos: torch.Tensor
                   ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Goals for n envs from their normal draws (n, 24) around their
        goal joint positions (n, 24): (goal, new goal joint positions)
        (reach.py:108-138). The goal sim runs on the compiled model, as
        the JAX package's does, whatever fields the envs override."""
        cst, m = self.constants, self.model
        lo, hi = self._goal_lo, self._goal_hi
        sample = torch.clamp(goal_joint_pos + 0.1 * (hi - lo) * noise, lo, hi)
        n = sample.shape[0]
        dg = self._initial(n)
        qpos = dg.qpos.clone()
        qpos[:, torch.as_tensor(self.hand.joint_qpos_ids, device=qpos.device)] = sample
        dg = dg.replace(qpos=qpos)
        if cst.goal_stabilize_steps > 0:
            ctrl = hand.denormalize_position_control(
                self.hand, m, dg, torch.zeros((n, 20), dtype=sample.dtype, device=sample.device),
                relative_action=True)
            dg = physics.step_n(m, dg.replace(ctrl=ctrl),
                                cst.goal_stabilize_steps * cst.mujoco_substeps)
        else:
            dg = physics.fwd_position(m, dg)
        self.goal_sims += 1
        self.goal_sim_envs += n
        return {"fingertip_pos": hand.fingertip_positions(self.hand, dg)}, \
            hand.joint_positions(self.hand, dg)

    def _goal_distance(self, goal, d: Data) -> Dict[str, torch.Tensor]:
        cur = hand.fingertip_positions(self.hand, d)
        return {"fingertip_pos": torch.linalg.vector_norm(goal["fingertip_pos"] - cur, dim=-1)}

    @property
    def _thresholds(self) -> Dict[str, float]:
        return {"fingertip_pos": self.constants.success_threshold}

    # env API
    def reset(self, batch: int, draws: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[core.EnvState, Dict[str, torch.Tensor]]:
        """`batch` new episodes from the settled start: (state, obs).
        `draws` as `draw_step` gives them (by default from the env's
        generator)."""
        draws = draws if draws is not None else self.draw_step(batch)
        d = physics.fwd_position(self.model, self._initial(batch))
        goal, gjp = self._next_goal(draws["goal_noise"], hand.joint_positions(self.hand, d))
        tracker = core.TrackerState.zero(batch, device=self.device).replace(
            success_steps_required=core.sample_success_steps_required(draws["pause_u"],
                                                                      self.constants))
        state = core.EnvState(
            physics=d, goal=goal, goal_aux=gjp, prev_goal_distance=self._goal_distance(goal, d),
            tracker=tracker, t=torch.zeros(batch, dtype=torch.int32, device=self.device))
        return state, self._observe(state)

    def step(self, state: core.EnvState, action: torch.Tensor,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        """One env step of `mujoco_substeps` physics substeps for the batch,
        with each env's `model_fields`: (state, obs, reward (B, 3),
        done (B,), info). `action` (B, 20) in [-1, 1]; `draws` as
        `draw_step` gives them (by default from the env's generator), used
        where an env's goal resamples."""
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

        # The JAX step's lax.cond under vmap runs the goal sim for every env
        # and selects; here the goal sim runs on the envs that resample only
        # (none: no goal sim), and its results are scattered into the batch.
        B = d.qpos.shape[0]
        draws = draws if draws is not None else self.draw_step(B)
        goal = dict(state.goal)
        gjp = state.goal_aux
        envs = torch.nonzero(need_new_goal).flatten()
        if envs.numel():
            new, new_gjp = self._next_goal(draws["goal_noise"][envs], state.goal_aux[envs])
            goal = {k: v.index_put((envs,), new[k]) for k, v in goal.items()}
            gjp = gjp.index_put((envs,), new_gjp)
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
        new_state = core.EnvState(physics=d, goal=goal, goal_aux=gjp,
                                  prev_goal_distance=dist_after, tracker=tracker,
                                  t=state.t + 1, model_fields=state.model_fields)
        reward = torch.stack([torch.zeros_like(goal_distance_reward).to(self.dtype),
                              goal_distance_reward.to(self.dtype),
                              success_reward.to(self.dtype)], dim=-1)
        done = done | crashed
        info = {"env_crash": crashed, "goal_dist": dist["fingertip_pos"],
                "is_successful": successful}
        info.update(core.tracker_info(tracker, cst))
        return new_state, self._observe(new_state), reward, done, info

    def _observe(self, state: core.EnvState) -> Dict[str, torch.Tensor]:
        """The default observation map (reference reach.py:160-171)."""
        d = state.physics
        dist = self._goal_distance(state.goal, d)
        return {
            "qpos": hand.joint_positions(self.hand, d),
            "qvel": hand.joint_velocities(self.hand, d),
            "fingertip_pos": hand.fingertip_positions(self.hand, d),
            "goal_fingertip_pos": state.goal["fingertip_pos"],
            "is_goal_achieved": core.is_successful(dist, self._thresholds)[:, None].to(self.dtype),
        }


def make_env(constants: Optional[dict] = None, device="cuda", seed: int = 0,
             snapshot: str = dactyl_reach_like.SNAPSHOT) -> ReachEnv:
    """The reach env on `device` (the card unless the caller asks for the
    CPU), on the compiled world `snapshot` (the reach stand-in by default),
    its draws seeded by `seed`."""
    with np.load(snapshot) as z:
        model = bridge.model_from_numpy({k: z[k] for k in z.files}, device)
    return ReachEnv(ReachEnvConstants(**(constants or {})), model, seed=seed)
