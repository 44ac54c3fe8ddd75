"""The dactyl face-perpendicular Rubik's env, batched: the Shadow Hand holds a
Rubik's cube whose two z faces turn (their driver hinges and the cubelets
they carry; every other cubelet joint removed), and is given goals that
alternate between flips of the whole cube and quarter turns of its upper
face.

Counterpart of `robogym_tpu/envs/dactyl/face_perpendicular.py`, with the
JAX package's semantics:
- goals: FaceCurriculumGoal (goals/face_curriculum.py:59-132). Where the
  faces are within 0.2 rad of straight, the cube within 0.4 rad of a
  z-aligned orientation, and a uniform draw is at least p_face_flip (0.25),
  the goal turns the face pointing up by a quarter (cw or ccw, signed by
  which face is up) and keeps the cube's orientation rounded to straight
  angles (a "rotation" goal, type 1); else the goal is a uniform z-rotation
  times the parallel quat putting a random z face up, the faces rounded to
  straight (a "flip" goal, type 0);
- distance: the cube's quat magnitude to its goal and the norm of the
  wrapped face-angle differences; success under 0.4 and 0.2;
- episode and reset: the locked env's (50 successes, 400 steps a goal, a
  drop ends the episode with drop_reward; the zero-control settle, pose
  wiggle and uniform quat, random warmup steps, retries until on the
  palm), the tracker counting steps and successes by goal type.

`reset(batch)` and `step(state, action)` work on a batch of envs; where the
JAX package branches per env (`lax.cond` on a goal resample) the port
selects per env with `torch.where`. Draws come from the env's
`torch.Generator`, or from the caller (`draws=`). The JAX package's goal
takes its flip decision (uniform) and its flipped face (randint) from one
key; the port takes two draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from robogym_torch import bridge
from robogym_torch.envs import core
from robogym_torch.envs.dactyl import cube_env
from robogym_torch.mjcf.compiler import compile_xml
from robogym_torch.mjcf.model import Data, Model
from robogym_torch.mjcf.xml_tools import MjcfXML
from robogym_torch.physics import step as physics
from robogym_torch.robot import shadow_hand as hand
from robogym_torch.utils import rotation as rot
from robogym_torch.worlds import rubik_face_like

# joints the face env removes from the perpendicular cube
# (face_perpendicular.py:77-129)
_REMOVED_DRIVERS = [
    "cubelet:driver:neg_x", "cubelet:driver:pos_x",
    "cubelet:driver:neg_y", "cubelet:driver:pos_y",
]
_REMOVED_ROTZ = [
    "cubelet:rotz:neg_x_pos_y", "cubelet:rotz:neg_x_neg_y",
    "cubelet:rotz:pos_x_pos_y", "cubelet:rotz:pos_x_neg_y",
]

# cubelets carried by each z face (face_perpendicular.py:275-296)
TOP_FACE_JOINTS = [
    "cubelet:driver:pos_z",
    "cubelet:rotz:neg_x_pos_y_pos_z", "cubelet:rotz:neg_x_neg_y_pos_z",
    "cubelet:rotz:neg_x_pos_z", "cubelet:rotz:pos_x_pos_z",
    "cubelet:rotz:pos_x_neg_y_pos_z", "cubelet:rotz:pos_x_pos_y_pos_z",
    "cubelet:rotz:neg_y_pos_z", "cubelet:rotz:pos_y_pos_z",
]
BOTTOM_FACE_JOINTS = [
    "cubelet:driver:neg_z",
    "cubelet:rotz:neg_x_pos_y_neg_z", "cubelet:rotz:neg_x_neg_y_neg_z",
    "cubelet:rotz:neg_x_neg_z", "cubelet:rotz:pos_x_neg_z",
    "cubelet:rotz:pos_x_neg_y_neg_z", "cubelet:rotz:pos_x_pos_y_neg_z",
    "cubelet:rotz:neg_y_neg_z", "cubelet:rotz:pos_y_neg_z",
]
GOAL_TYPES = ("flip", "rotation")


def _face_cube_edits(xml: MjcfXML) -> MjcfXML:
    """The perpendicular cube with every joint but the two z faces' removed
    (face_perpendicular.py:77-101)."""
    xml = (
        xml
        .remove_objects_by_prefix(prefix="cubelet:rotx:", tag="joint")
        .remove_objects_by_prefix(prefix="cubelet:roty:", tag="joint")
        .remove_objects_by_prefix(prefix="cubelet:spring:", tag="joint")
        .remove_objects_by_name(names=_REMOVED_ROTZ, tag="joint")
    )
    for n in _REMOVED_DRIVERS:
        xml = xml.remove_objects_by_name(n, tag="joint")
    return xml


def build_face_world_xml() -> MjcfXML:
    """The face env's world from the assets: the edited perpendicular cube
    `cube:`, the floor, the hand and the light; no target cube (the
    reference's is for rendering; goals are data here)."""
    xml = MjcfXML()
    xml.add_default_compiler_directive()
    cube = _face_cube_edits(MjcfXML.parse("rubik/rubik_perpendicular.xml"))
    cube.add_name_prefix("cube:")
    cube.set_named_objects_attr("cube:middle", tag="body", pos=[1.0, 0.87, 0.2])
    xml.append(cube)
    xml.append(
        MjcfXML.parse("floor/basic_floor.xml").set_named_objects_attr(
            "floor", tag="body", pos=[1, 1, 0]
        )
    )
    xml.append(cube_env.hand_xml())
    xml.append(MjcfXML.parse("light/default.xml"))
    return xml


def compile_world(constants=None, device="cuda") -> Model:
    """The face env's world composed from the assets and compiled on
    `device` (the card unless the caller asks for the CPU), as the JAX
    constructor compiles it (face_perpendicular.py:123); the env sets its
    timestep from its constants."""
    return compile_xml(build_face_world_xml(), device=device)


@dataclasses.dataclass(frozen=True)
class FacePerpendicularEnvConstants(cube_env.DactylCubeEnvConstants):
    """(face_perpendicular.py:47-68)."""

    success_threshold_cube_quat: float = 0.4
    success_threshold_face_angle: float = 0.2
    goal_generation: str = "face_curr"
    goal_directions: Tuple[str, ...] = ("cw", "ccw")
    round_target_face: bool = True
    p_face_flip: float = 0.25


def _goal_quat_for_face() -> np.ndarray:
    """(2, 4) the parallel quats putting each z face up (pos_z, then neg_z):
    of the 24, the one that turns the face's local z axis most nearly to
    world +z (face_perpendicular.py:168-184, host numpy)."""
    pq = cube_env.PARALLEL_QUATS
    ups = []
    for sign in (1.0, -1.0):  # pos_z face, neg_z face
        zs = []
        for q in pq:
            w, x, y, z = q
            # third column of R(q) z-component: rotation of local z
            Rz = np.array([
                2 * (x * z + w * y), 2 * (y * z - w * x),
                1 - 2 * (x * x + y * y),
            ])
            zs.append(sign * Rz[2])
        ups.append(pq[int(np.argmax(zs))])
    return np.stack(ups)


class FacePerpendicularEnv(cube_env.CubeEnvBase):
    """The face-perpendicular env on a batch: `reset(batch)`,
    `step(state, action)`."""

    def __init__(self, constants: Optional[FacePerpendicularEnvConstants] = None,
                 model: Optional[Model] = None, seed: int = 0):
        constants = constants or FacePerpendicularEnvConstants()
        if model is None:
            raise ValueError("FacePerpendicularEnv takes a compiled model (see make_env)")
        c = model.const
        jn = c.names["joint"]

        def qadr(name):
            return int(c.jnt_qposadr[jn[name]])

        self.driver_qpos = np.asarray([qadr("cube:cubelet:driver:pos_z"),
                                       qadr("cube:cubelet:driver:neg_z")], np.int64)
        self.top_face_qpos = np.asarray([qadr(f"cube:{j}") for j in TOP_FACE_JOINTS], np.int64)
        self.bottom_face_qpos = np.asarray([qadr(f"cube:{j}") for j in BOTTOM_FACE_JOINTS],
                                           np.int64)
        self.goal_quat_for_face = _goal_quat_for_face()
        self._driver_ix = torch.as_tensor(self.driver_qpos, device=model.device)
        super().__init__(constants, model, seed=seed)

    def build_cube_index(self, model: Model) -> cube_env.CubeIndex:
        return cube_env.rubik_cube_index(model)

    # ------------------------------------------------------------------
    def face_angles(self, d: Data) -> torch.Tensor:
        """(B, 2) the driver angles, pos_z then neg_z
        (face_perpendicular.py:237-239)."""
        return d.qpos[:, self._driver_ix]

    @property
    def _thresholds(self) -> Dict[str, float]:
        return {"cube_quat": self.constants.success_threshold_cube_quat,
                "cube_face_angle": self.constants.success_threshold_face_angle}

    def _goal_distance(self, goal, d: Data) -> Dict[str, torch.Tensor]:
        """(goals/face_curriculum.py:161-172)."""
        rel_quat = rot.quat_difference(goal["cube_quat"], cube_env.cube_quat(self.cube, d))
        rel_face = rot.normalize_angles(goal["cube_face_angle"] - self.face_angles(d))
        return {"cube_quat": rot.quat_magnitude(rel_quat),
                "cube_face_angle": rot.norm(rel_face)}

    def draw_step(self, n: int) -> Dict[str, torch.Tensor]:
        """One step's (or reset's) goal and hold draws for n envs, each
        (n,): the flip decision `flip_u` and the goal's z-rotation `z_u`,
        uniform in [0, 1); the turn direction `direction`, an index into
        `goal_directions`; the face to put up `face`, 0 or 1; the
        success-hold draw `pause_u`."""
        g, dev, dt = self.generator, self.device, self.dtype
        return dict(
            flip_u=torch.rand((n,), generator=g, dtype=dt, device=dev),
            direction=torch.randint(0, len(self.constants.goal_directions), (n,), generator=g,
                                    device=dev),
            face=torch.randint(0, 2, (n,), generator=g, device=dev),
            z_u=torch.rand((n,), generator=g, dtype=dt, device=dev),
            pause_u=torch.rand((n,), generator=g, dtype=dt, device=dev))

    def _next_goal(self, draws: Dict[str, torch.Tensor], d: Data) -> Dict[str, torch.Tensor]:
        """FaceCurriculumGoal.next_goal (goals/face_curriculum.py:59-132) for
        the batch, on `draw_step`'s draws."""
        cst = self.constants
        cube_quat = cube_env.cube_quat(self.cube, d)
        cube_face = self.face_angles(d)
        rounded_face = rot.round_to_straight_angles(cube_face)
        face_diff = rot.normalize_angles(cube_face - rounded_face)
        face_aligned = rot.norm(face_diff) < cst.success_threshold_face_angle
        z_aligned = rot.rot_z_aligned(cube_quat, cst.success_threshold_cube_quat)
        do_reorient = draws["flip_u"] < cst.p_face_flip
        rotate_face = face_aligned & z_aligned & ~do_reorient

        # the face rotation: turn the face pointing up (pos_z when the cube's
        # z axis points up), cw or ccw times (-1)^face
        face_up = torch.where(rot.quat2mat(cube_quat)[:, 2, 2] > 0, 0, 1)
        clockwise = torch.where(face_up == 0, 1.0, -1.0).to(self.dtype)
        dirs = [a for name, a in (("cw", np.pi / 2), ("ccw", -np.pi / 2))
                if name in cst.goal_directions]
        choices = torch.tensor(dirs, dtype=self.dtype, device=self.device)
        delta = choices[draws["direction"]] * clockwise
        up = torch.arange(2, device=self.device) == face_up[:, None]
        goal_face_rot = rot.normalize_angles(torch.where(up, rounded_face + delta[:, None],
                                                         rounded_face))
        goal_quat_rot = rot.round_to_straight_quat(cube_quat)

        # the flip: faces straight, a random z face up, a random z-rotation
        face_up_quat = torch.as_tensor(self.goal_quat_for_face, dtype=self.dtype,
                                       device=self.device)[draws["face"]]
        goal_quat_flip = rot.quat_mul(cube_env.uniform_z_aligned_quat(draws["z_u"]), face_up_quat)

        goal_quat = torch.where(rotate_face[:, None], goal_quat_rot, goal_quat_flip)
        goal_face = torch.where(rotate_face[:, None], goal_face_rot, rounded_face)
        return {"cube_quat": rot.quat_normalize(goal_quat), "cube_face_angle": goal_face,
                # 0 = flip, 1 = rotation (face_curriculum.py:131)
                "goal_type": rotate_face.to(torch.int32)}

    # env API
    def reset(self, batch: int, attempts: Optional[List[Dict[str, torch.Tensor]]] = None,
              draws: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[core.EnvState, Dict[str, torch.Tensor]]:
        """`batch` new episodes: (state, obs). `attempts` are the reset
        attempts' draws (`CubeEnvBase.reset_physics`), `draws` the goal's
        and hold's (`draw_step`); by default both come from the env's
        generator."""
        d = self.reset_physics(batch, attempts)
        draws = draws if draws is not None else self.draw_step(batch)
        goal = self._next_goal(draws, d)
        tracker = core.TrackerState.zero(batch, n_goal_types=len(GOAL_TYPES),
                                         device=self.device).replace(
            success_steps_required=core.sample_success_steps_required(draws["pause_u"],
                                                                      self.constants))
        state = core.EnvState(
            physics=d, goal=goal, goal_aux=torch.zeros(batch, dtype=self.dtype, device=self.device),
            prev_goal_distance=self._goal_distance(goal, d), tracker=tracker,
            t=torch.zeros(batch, dtype=torch.int32, device=self.device))
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
        goal_type = state.goal["goal_type"]
        tracker, success_reward, done, need_new_goal = core.tracker_process(
            state.tracker, cst, successful, torch.zeros_like(successful), goal_type=goal_type)

        env_reward = torch.zeros_like(goal_distance_reward)
        if cst.stop_on_fall:
            fallen = ~cube_env.is_on_palm(self.cube, d)
            done = done | fallen
            env_reward = torch.where(fallen, cst.drop_reward, 0.0).to(self.dtype)

        draws = draws if draws is not None else self.draw_step(d.qpos.shape[0])
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
        new_state = core.EnvState(physics=d, goal=goal, goal_aux=state.goal_aux,
                                  prev_goal_distance=dist_after, tracker=tracker,
                                  t=state.t + 1, model_fields=state.model_fields)
        reward = torch.stack([env_reward, goal_distance_reward.to(self.dtype),
                              success_reward.to(self.dtype)], dim=-1)
        done = done | crashed
        info = {"env_crash": crashed, "is_successful": successful,
                "goal_dist_quat": dist["cube_quat"], "goal_dist_face": dist["cube_face_angle"]}
        info.update(core.tracker_info(tracker, cst, GOAL_TYPES, goal_type=goal_type))
        return new_state, self._observe(new_state), reward, done, info

    def _observe(self, state: core.EnvState) -> Dict[str, torch.Tensor]:
        """(face_perpendicular.py:297-313 observation map)."""
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
             model: Optional[Model] = None) -> FacePerpendicularEnv:
    """The face env on `device` (the card unless the caller asks for the
    CPU), on `model` or else the committed cubelet stand-in world
    (`worlds/rubik_face_like.npz`), its draws seeded by `seed`."""
    if model is None:
        with np.load(rubik_face_like.SNAPSHOT) as z:
            model = bridge.model_from_numpy({k: z[k] for k in z.files}, device)
    return FacePerpendicularEnv(FacePerpendicularEnvConstants(**(constants or {})), model,
                                seed=seed)
