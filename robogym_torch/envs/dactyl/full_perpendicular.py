"""The dactyl full-perpendicular Rubik's env, batched: the Shadow Hand holds a
whole Rubik's cube (6 face drivers and 20 cubelets on euler hinges), whose
reset scrambles it, and is given goals that turn faces or reorient the
cube.

Counterpart of `robogym_tpu/envs/dactyl/full_perpendicular.py`, with the
JAX package's semantics:
- reset: the zero-control settle's state, `num_scramble_steps` (50) random
  quarter turns of the cube (`cube_manipulator.scramble`), each face angle
  moved by a uniform draw in [-0.1, 0.1], then the dactyl pose loop (cube
  position wiggle and uniform orientation, random warmup steps, retries
  from the scrambled state until the cube is on the palm);
- goals by `goal_generation`:
  * face_free (the default), face_curr, full_unconstrained: a "rotation"
    goal (type 1) turns the face pointing up (any face under
    full_unconstrained) by a quarter, where the faces are within 0.2 rad of
    straight, some cube axis within 0.4 rad of up and a uniform draw is at
    least p_face_flip (every time under full_unconstrained); else a "flip"
    goal (type 0): a uniform z-rotation times the quat putting a random
    face up, the faces rounded to straight. The rotation goal keeps the
    orientation rounded to straight angles (face_curr) or with its up
    face exactly up (else);
  * the solver modes (unconstrained_cube_solver, face_cube_solver,
    release_cube_solver, solver) walk a two-phase solution, one face turn
    a goal, with that face up; the plan starts empty and the host attaches
    it after the reset (`goals_solver.solve_and_attach`);
    fixed_fair_scramble walks a fixed plan that needs no solve;
- distance: the cube's quat distance (face_curr: to the goal quat;
  full_unconstrained: none; else, for rotation goals, the planned face's
  distance from up) and the norm of the wrapped face-angle differences;
  success under 0.4 and 0.2 (release_cube_solver: 0.05 for the faces
  once the plan is done, which then ends the trial as solved);
- episode: the locked env's (50 successes, 1600 steps a goal, a drop ends
  the episode with drop_reward), the tracker by goal type.

`reset(batch)` and `step(state, action)` work on a batch of envs; where the
JAX package branches per env (`lax.cond`) the port selects per env with
`torch.where`. Draws come from the env's `torch.Generator`, or from the
caller. The JAX goal takes the face to turn (full_unconstrained) and the
face to put up in a flip from one key with one randint, so they are equal;
the port takes one draw for both.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from robogym_torch import bridge
from robogym_torch.envs import core
from robogym_torch.envs.dactyl import cube_env, goals_solver
from robogym_torch.envs.dactyl import cube_manipulator as manip
from robogym_torch.mjcf.model import Data, Model
from robogym_torch.physics import step as physics
from robogym_torch.robot import shadow_hand as hand
from robogym_torch.utils import rotation as rot
from robogym_torch.utils import rubik_utils
from robogym_torch.worlds import rubik_full_like

GOAL_TYPES = ("flip", "rotation")
# the kociemba-driven generators, backed by the two-phase solver, and the
# fixed plan of fixed_fair_scramble (full_perpendicular.py:201-267)
SOLVER_MODES = ("unconstrained_cube_solver", "face_cube_solver", "release_cube_solver",
                "fixed_fair_scramble", "solver")
GOAL_GENERATIONS = ("face_free", "face_curr", "full_unconstrained") + SOLVER_MODES
# the WCA "fair scramble" (goals/fixed_fair_scramble.py:17-19); its half
# turns become two quarter-turn goals (rubik_cube_solver.py:86-120)
FIXED_FAIR_SCRAMBLE = "L2 U2 R2 B D2 B2 D2 L2 F' D' R B F L U' F D' L2"


@dataclasses.dataclass(frozen=True)
class FullPerpendicularEnvConstants(cube_env.DactylCubeEnvConstants):
    """(full_perpendicular.py:56-90)."""

    success_threshold_cube_quat: float = 0.4
    success_threshold_face_angle: float = 0.2
    max_timesteps_per_goal: int = 1600
    goal_generation: str = "face_free"
    goal_directions: Tuple[str, ...] = ("cw", "ccw")
    round_target_face: bool = True
    p_face_flip: float = 0.5
    num_scramble_steps: int = 50
    scramble_face_angles: bool = True
    randomize_face_angles: bool = True


def _goal_quat_for_face() -> np.ndarray:
    """(6, 4) for each face (DRIVER_NAMES order) the parallel quat of the
    24 that turns its outward axis most nearly to world +z (host numpy)."""
    ups = []
    for fa in manip.DRIVER_COORDS:
        zs = []
        for w, x, y, z in cube_env.PARALLEL_QUATS:
            R = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
            ])
            zs.append((R @ fa)[2])
        ups.append(cube_env.PARALLEL_QUATS[int(np.argmax(zs))])
    return np.stack(ups)


class FullPerpendicularEnv(cube_env.CubeEnvBase):
    """The full-perpendicular env on a batch: `reset(batch)`,
    `step(state, action)`."""

    def __init__(self, constants: Optional[FullPerpendicularEnvConstants] = None,
                 model: Optional[Model] = None, seed: int = 0):
        constants = constants or FullPerpendicularEnvConstants()
        if model is None:
            raise ValueError("FullPerpendicularEnv takes a compiled model (see make_env)")
        if constants.goal_generation not in GOAL_GENERATIONS:
            raise ValueError(f"goal_generation {constants.goal_generation!r}: not one of "
                             f"{GOAL_GENERATIONS}")
        self.cubelets = manip.CubeletIndex.build(model, "cube:")
        self.goal_quat_for_face = _goal_quat_for_face()
        self._driver_ix = torch.as_tensor(self.cubelets.driver_qpos, dtype=torch.long,
                                          device=model.device)
        super().__init__(constants, model, seed=seed)

    def build_cube_index(self, model: Model) -> cube_env.CubeIndex:
        return cube_env.rubik_cube_index(model)

    @property
    def solver_mode(self) -> bool:
        """Whether the goals walk a solution plan (SOLVER_MODES)."""
        return self.constants.goal_generation in SOLVER_MODES

    # ------------------------------------------------------------------
    def face_angles(self, d: Data) -> torch.Tensor:
        """(B, 6) the driver angles, DRIVER_NAMES order
        (full_perpendicular.py:145-148)."""
        return d.qpos[:, self._driver_ix]

    @property
    def _thresholds(self) -> Dict[str, float]:
        return {"cube_quat": self.constants.success_threshold_cube_quat,
                "cube_face_angle": self.constants.success_threshold_face_angle}

    def _goal_distance(self, goal, d: Data) -> Dict[str, torch.Tensor]:
        """face_curr: the full quat distance (goals/face_curriculum.py:
        152-168); full_unconstrained: no orientation objective
        (goals/full_unconstrained.py:80-84); face_free and the solver
        modes: for rotation goals how far the goal's face is from up, for
        flips the full quat distance (goals/face_free.py:151-163)."""
        cur_quat = cube_env.cube_quat(self.cube, d)
        full_dist = rot.quat_magnitude(rot.quat_difference(goal["cube_quat"], cur_quat))
        mode = self.constants.goal_generation
        if mode == "full_unconstrained":
            quat_dist = torch.zeros_like(full_dist)
        elif mode == "face_curr":
            quat_dist = full_dist
        else:
            up = rot.quat_magnitude(cube_env.distance_quat_from_being_up(
                cur_quat, goal["axis_nr"].long(), goal["axis_sign"]))
            quat_dist = torch.where(goal["goal_type"] > 0, up, full_dist)
        rel_face = rot.normalize_angles(goal["cube_face_angle"] - self.face_angles(d))
        return {"cube_quat": quat_dist, "cube_face_angle": rot.norm(rel_face)}

    def draw_step(self, n: int) -> Dict[str, torch.Tensor]:
        """One step's (or reset's) goal and hold draws for n envs, each
        (n,): the flip decision `flip_u`, the goal's z-rotation `z_u` and
        the unrounded turn `angle_u` (round_target_face off), uniform in
        [0, 1); the turn direction `direction`, an index into
        `goal_directions`; `face` in [0, 6), the face turned under
        full_unconstrained and the face put up by a flip; the success-hold
        draw `pause_u`."""
        g, dev, dt = self.generator, self.device, self.dtype
        return dict(
            flip_u=torch.rand((n,), generator=g, dtype=dt, device=dev),
            direction=torch.randint(0, len(self.constants.goal_directions), (n,), generator=g,
                                    device=dev),
            z_u=torch.rand((n,), generator=g, dtype=dt, device=dev),
            face=torch.randint(0, 6, (n,), generator=g, device=dev),
            angle_u=torch.rand((n,), generator=g, dtype=dt, device=dev),
            pause_u=torch.rand((n,), generator=g, dtype=dt, device=dev))

    def _next_goal(self, draws: Dict[str, torch.Tensor], d: Data) -> Dict[str, torch.Tensor]:
        """The face_free / face_curr / full_unconstrained goal
        (goals/face_free.py, face_curriculum.py, full_unconstrained.py) for
        the batch, on `draw_step`'s draws."""
        cst, dt, dev = self.constants, self.dtype, self.device
        mode = cst.goal_generation
        cube_quat = cube_env.cube_quat(self.cube, d)
        cube_face = self.face_angles(d)
        rounded_face = rot.round_to_straight_angles(cube_face)
        face_diff = rot.normalize_angles(cube_face - rounded_face)
        face_aligned = rot.norm(face_diff) < cst.success_threshold_face_angle
        xyz_aligned = rot.rot_xyz_aligned(cube_quat, cst.success_threshold_cube_quat)
        do_reorient = draws["flip_u"] < cst.p_face_flip
        rotate_face = face_aligned & xyz_aligned & ~do_reorient
        if mode == "full_unconstrained":
            rotate_face = torch.ones_like(rotate_face)

        # the face to turn: the one pointing up (cube_utils.face_up), or any
        # under full_unconstrained (the same draw as the flip's face)
        coords = torch.as_tensor(manip.DRIVER_COORDS.T, dtype=dt, device=dev)
        axes_world = rot.quat2mat(cube_quat) @ coords                      # (B, 3, 6)
        face_up = torch.argmax(axes_world[:, 2], dim=-1)
        face = draws["face"].long()
        face_to_shift = face if mode == "full_unconstrained" else face_up

        # (cube_utils.rotated_face_with_angle:96-135)
        clockwise = torch.where(face_to_shift % 2 == 0, 1.0, -1.0).to(dt)
        dirs = [a for name, a in (("cw", np.pi / 2), ("ccw", -np.pi / 2))
                if name in cst.goal_directions]
        if cst.round_target_face:
            delta = torch.tensor(dirs, dtype=dt, device=dev)[draws["direction"]] * clockwise
        else:
            delta = core.uniform_apply(draws["angle_u"], -np.pi / 2, np.pi / 2)
        hit = torch.arange(6, device=dev) == face_to_shift[:, None]
        goal_face_rot = rot.normalize_angles(torch.where(hit, rounded_face + delta[:, None],
                                                         rounded_face))
        if mode == "face_curr":
            goal_quat_rot = rot.round_to_straight_quat(cube_quat)
        else:
            goal_quat_rot = cube_env.align_quat_up(cube_quat)

        face_up_quat = torch.as_tensor(self.goal_quat_for_face, dtype=dt, device=dev)[face]
        goal_quat_flip = rot.quat_mul(cube_env.uniform_z_aligned_quat(draws["z_u"]), face_up_quat)

        axis_nr, axis_sign = cube_env.up_axis_with_sign(cube_quat)
        return {
            "cube_quat": rot.quat_normalize(torch.where(rotate_face[:, None], goal_quat_rot,
                                                        goal_quat_flip)),
            "cube_face_angle": torch.where(rotate_face[:, None], goal_face_rot, rounded_face),
            "goal_type": rotate_face.to(torch.int32),
            "axis_nr": axis_nr.to(torch.int32),
            "axis_sign": axis_sign.to(dt),
        }

    # ------------------------------------------------------------------
    def draw_start(self, n: int) -> Dict[str, torch.Tensor]:
        """The scramble's draws for n envs (`cube_manipulator.draw_scramble`
        over `num_scramble_steps`) and `face_u` (n, 6), uniform in [0, 1),
        the face-angle noise."""
        out = manip.draw_scramble(self.generator, n, self.constants.num_scramble_steps,
                                  self.device)
        out["face_u"] = torch.rand((n, 6), generator=self.generator, dtype=self.dtype,
                                   device=self.device)
        return out

    def scrambled_start(self, batch: int, start: Dict[str, torch.Tensor]) -> Data:
        """The settled state for `batch` envs, scrambled and with its face
        angles moved (full_perpendicular.py reset_physics), on `draw_start`'s
        draws."""
        cst = self.constants
        d = core.data_map(lambda x: x.expand((batch,) + x.shape[1:]).clone(), self._settled_data)
        qpos = d.qpos
        if cst.num_scramble_steps > 0:
            qpos = manip.scramble(self.cubelets, qpos, start)
        if cst.randomize_face_angles:
            qpos = qpos.clone()
            qpos[:, self._driver_ix] = (qpos[:, self._driver_ix]
                                        + core.uniform_apply(start["face_u"], -0.1, 0.1))
        return d.replace(qpos=qpos)

    def reset_physics(self, batch: int, attempts: Optional[List[Dict[str, torch.Tensor]]] = None,
                      start: Optional[Dict[str, torch.Tensor]] = None) -> Data:
        """The scrambled start (`scrambled_start`), then the pose loop from
        it (`CubeEnvBase.reset_physics`, retries from each env's own
        scrambled state). `start` are `draw_start`'s draws, `attempts` the
        pose loop's; by default both come from the env's generator."""
        start = start if start is not None else self.draw_start(batch)
        return super().reset_physics(batch, attempts,
                                     initial=self.scrambled_start(batch, start))

    def fixed_scramble_plan(self, batch: int):
        """(plan (B, MAX_SOLUTION_LEN, 3), length (B,) int32) of
        fixed_fair_scramble, the same in every env: its quarter turns as
        (axis, side, angle) rows, each half turn as two."""
        steps = []
        for axis, side, angle in rubik_utils.moves_to_face_rotations(FIXED_FAIR_SCRAMBLE):
            n = 2 if abs(angle) > np.pi / 2 + 1e-6 else 1
            steps += [(axis, side, angle / n)] * n
        steps = steps[:goals_solver.MAX_SOLUTION_LEN]
        plan = np.zeros((goals_solver.MAX_SOLUTION_LEN, 3), np.float32)
        plan[:len(steps)] = steps
        plan_t = torch.as_tensor(plan, dtype=self.dtype, device=self.device)
        return (plan_t.expand(batch, -1, -1).clone(),
                torch.full((batch,), len(steps), dtype=torch.int32, device=self.device))

    def _solver_goal(self, d: Data, aux) -> Dict[str, torch.Tensor]:
        """The goal of each env's current solution step: the planned face
        angles, the planned face up (a rotation goal); past the plan the
        faces and the orientation rounded to straight (type 0)
        (face_cube_solver.py:54-165)."""
        plan, length, step = aux
        dt = self.dtype
        in_plan = step < length
        planned = goals_solver.goal_face_angles_after(self.cubelets, d.qpos, plan, step).to(dt)
        aligned = rot.round_to_straight_angles(self.face_angles(d))
        entry = goals_solver.plan_entry(plan, step)
        didx = entry[:, 0].to(torch.int32) * 2 + entry[:, 1].to(torch.int32)
        face_up_quat = torch.as_tensor(self.goal_quat_for_face, dtype=dt,
                                       device=self.device)[didx.long()]
        cur_quat = rot.round_to_straight_quat(cube_env.cube_quat(self.cube, d))
        return {
            "cube_quat": rot.quat_normalize(torch.where(in_plan[:, None], face_up_quat, cur_quat)),
            "cube_face_angle": torch.where(in_plan[:, None], planned, aligned),
            "goal_type": in_plan.to(torch.int32),
            # the face's cube-frame axis: DRIVER_NAMES is [-x, +x, -y, +y, -z, +z]
            "axis_nr": torch.div(didx, 2, rounding_mode="floor"),
            "axis_sign": torch.where(didx % 2 == 0, -1.0, 1.0).to(dt),
        }

    # env API
    def reset(self, batch: int, attempts: Optional[List[Dict[str, torch.Tensor]]] = None,
              draws: Optional[Dict[str, torch.Tensor]] = None,
              start: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[core.EnvState, Dict[str, torch.Tensor]]:
        """`batch` new episodes: (state, obs). `start` are the scramble's
        draws (`draw_start`), `attempts` the pose loop's, `draws` the
        goal's and hold's (`draw_step`); by default all come from the env's
        generator. In a solver mode but fixed_fair_scramble the plan is
        empty until `goals_solver.solve_and_attach`."""
        cst = self.constants
        start = start if start is not None else self.draw_start(batch)
        d = self.reset_physics(batch, attempts, start)
        draws = draws if draws is not None else self.draw_step(batch)
        zero = torch.zeros(batch, dtype=torch.int32, device=self.device)
        if cst.goal_generation == "fixed_fair_scramble":
            aux = (*self.fixed_scramble_plan(batch), zero)
            goal = self._solver_goal(d, aux)
        elif self.solver_mode:
            aux = (*goals_solver.empty_plan(batch, self.dtype, self.device), zero)
            goal = self._solver_goal(d, aux)
        else:
            aux = torch.zeros(batch, dtype=self.dtype, device=self.device)
            goal = self._next_goal(draws, d)
        tracker = core.TrackerState.zero(batch, n_goal_types=len(GOAL_TYPES),
                                         device=self.device).replace(
            success_steps_required=core.sample_success_steps_required(draws["pause_u"], cst))
        state = core.EnvState(
            physics=d, goal=goal, goal_aux=aux, prev_goal_distance=self._goal_distance(goal, d),
            tracker=tracker, t=torch.zeros(batch, dtype=torch.int32, device=self.device))
        return state, self._observe(state)

    def _replan_needed(self, goal, d: Data, length: torch.Tensor) -> torch.Tensor:
        """(B,) a rotation goal that another face turned by a quarter or
        more (or its own face by more) has made unreachable, with a plan
        attached: the host should solve again (face_cube_solver.py:167-196)."""
        rel_face = rot.normalize_angles(goal["cube_face_angle"] - self.face_angles(d))
        rounded = rot.round_to_straight_angles(torch.abs(rel_face))
        goal_face = goal["axis_nr"].long() * 2 + (goal["axis_sign"] > 0).long()
        hit = torch.arange(6, device=self.device) == goal_face[:, None]
        other = torch.where(hit, torch.zeros_like(rounded), rounded)
        own = torch.gather(rounded, 1, goal_face[:, None])[:, 0]
        unreachable = (goal["goal_type"] > 0) & ((other > 1e-6).any(-1) | (own > np.pi / 2 + 1e-6))
        return unreachable & (length > 0)

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
        solved = torch.zeros_like(successful)
        if cst.goal_generation == "release_cube_solver":
            # past the plan the faces must be within 0.05, and reaching that
            # last goal ends the trial as solved (goals/release_cube_solver.py:9-30)
            _, length0, step0 = state.goal_aux
            past_plan = (step0 >= length0) & (length0 > 0)
            thr_face = torch.where(past_plan, 0.05, cst.success_threshold_face_angle)
            successful = ((dist["cube_quat"] < cst.success_threshold_cube_quat)
                          & (dist["cube_face_angle"] < thr_face))
            solved = past_plan & successful
        goal_type = state.goal["goal_type"]
        tracker, success_reward, done, need_new_goal = core.tracker_process(
            state.tracker, cst, successful, solved, goal_type=goal_type)

        env_reward = torch.zeros_like(goal_distance_reward)
        if cst.stop_on_fall:
            fallen = ~cube_env.is_on_palm(self.cube, d)
            done = done | fallen
            env_reward = torch.where(fallen, cst.drop_reward, 0.0).to(self.dtype)

        draws = draws if draws is not None else self.draw_step(d.qpos.shape[0])
        if self.solver_mode:
            plan, length, step = state.goal_aux
            goal_aux = (plan, length, torch.where(need_new_goal, step + 1, step))
            new = self._solver_goal(d, goal_aux)
        else:
            goal_aux = state.goal_aux
            new = self._next_goal(draws, d)
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
        new_state = core.EnvState(physics=d, goal=goal, goal_aux=goal_aux,
                                  prev_goal_distance=dist_after, tracker=tracker,
                                  t=state.t + 1, model_fields=state.model_fields)
        reward = torch.stack([env_reward, goal_distance_reward.to(self.dtype),
                              success_reward.to(self.dtype)], dim=-1)
        done = done | crashed
        info = {"env_crash": crashed, "is_successful": successful,
                "goal_dist_quat": dist["cube_quat"], "goal_dist_face": dist["cube_face_angle"]}
        info.update(core.tracker_info(tracker, cst, GOAL_TYPES, goal_type=goal_type))
        if self.solver_mode:
            _, length_f, step_f = goal_aux
            # stepped without `solve_and_attach`, a solver env has an empty plan
            info["solver_plan_empty"] = (length_f == 0) & (
                cst.goal_generation != "fixed_fair_scramble")
            info["solver_plan_step"] = step_f
            info["solver_replan_needed"] = self._replan_needed(state.goal, d, length_f)
        return new_state, self._observe(new_state), reward, done, info

    def _observe(self, state: core.EnvState) -> Dict[str, torch.Tensor]:
        """(full_perpendicular.py:184-199 observation map)."""
        d = state.physics
        B = d.qpos.shape[0]
        return {
            "cube_pos": cube_env.cube_pos(self.cube, d),
            "cube_quat": cube_env.cube_quat(self.cube, d),
            "cube_face_angle": self.face_angles(d),
            "qpos": d.qpos,
            "qvel": d.qvel,
            "hand_angle": hand.joint_positions(self.hand, d),
            "fingertip_pos": cube_env.relative_fingertip_positions(self.hand, self.model, d),
            "goal_pos": torch.zeros((B, 3), dtype=self.dtype, device=self.device),
            "goal_quat": state.goal["cube_quat"],
            "goal_face_angle": state.goal["cube_face_angle"],
        }


def make_env(constants: Optional[dict] = None, device="cuda", seed: int = 0,
             model: Optional[Model] = None) -> FullPerpendicularEnv:
    """The full env on `device` (the card unless the caller asks for the
    CPU), on `model` or else the committed stand-in world
    (`worlds/rubik_full_like.npz`), its draws seeded by `seed`."""
    if model is None:
        with np.load(rubik_full_like.SNAPSHOT) as z:
            model = bridge.model_from_numpy({k: z[k] for k in z.files}, device)
    return FullPerpendicularEnv(FullPerpendicularEnvConstants(**(constants or {})), model,
                                seed=seed)
