"""The rearrange blocks env, batched: a UR16e arm with a two-finger gripper
over a table with `num_objects` blocks; goals are free placements of every
block; the reward is the change in the number of blocks within the success
threshold; an episode ends when a block leaves the table, after
`max_timesteps_per_goal_per_obj * num_objects` steps a goal, or after
`successes_needed` goals.

Counterpart of `robogym_tpu/envs/rearrange/blocks.py`, with its default
control: TCP position, roll and yaw through the mocap_ik dual sim. Each env
step (1) scales the TCP command by the force limiter, (2) syncs the solver
sim to the main sim's arm and gripper, positions it, moves its mocap
target by the action and steps it `mujoco_substeps` times, and makes its
arm's joint positions the main sim's joint targets, (3) sets the gripper
target, (4) steps the main sim `mujoco_substeps` times, (5) guards against
divergence, (6) rewards, penalises and ends episodes, (7) resamples goals.

`reset(batch)` and `step(state, action)` work on a batch of envs, each
tensor `(B, ...)`; where the JAX package branches per env (`lax.cond` on a
goal resample) the port selects per env with `torch.where`, and draws the
resample for every env and every step, as the JAX package splits its key.
Draws come from the env's `torch.Generator`, or from the caller (`draws=`).

Goals come from `goal_generation`'s class (`GOAL_CLASSES`); under
`goal_args` `stabilize_goal` each drawn goal is settled for
`stabilize_steps * mujoco_substeps` substeps: primitive objects in the
objects-only settle world (`settle_model`: floor, table and blocks), for
every env at every step as the resample is; mesh objects, whose hulls are
each env's own model fields, in the full model from the env's own state
(`_settle_in_model`), at a step only on the envs that resample.
`mask_obs_outside_placement_area` adds the masked observations, and
`soft_mask` makes both placement masks soft. Subclasses override
`sample_object_groups`, `_reset_model_fields` (the per-episode model
fields) and `_check_objects`. `material_names` gives each object group
a material (`materials.py`) as per-env geom and body fields; `vision` adds
the rendered images `vision_obs`, `vision_obs_mobile` and `vision_goal`
(the goal state, the robot hidden) to every observation
(`render/raycast.py`), on a world with the vision cameras
(`worlds/vision_like.py`); the cameras' and lights' randomization
(`camera_*_radius`, `light_*`) draws per-env model fields at each reset.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from robogym_torch import bridge
from robogym_torch.envs import core
from robogym_torch.envs.rearrange import goals as goals_lib
from robogym_torch.envs.rearrange import materials as materials_lib
from robogym_torch.envs.rearrange import simulation as sim_lib
from robogym_torch.mjcf.model import Data, GeomType, Model, make_data
from robogym_torch.observation import vision as vision_lib
from robogym_torch.physics import step as physics
from robogym_torch.randomization import vision as vision_rand
from robogym_torch.robot import composite as composite_lib
from robogym_torch.robot import gripper as gripper_lib
from robogym_torch.robot import tcp_force_limiter as limiter
from robogym_torch.robot import tcp_solver
from robogym_torch.robot import ur16e as arm_lib
from robogym_torch.utils import rotation as rot
from robogym_torch.worlds import rearrange_blocks_like, vision_like


@dataclasses.dataclass(frozen=True)
class RearrangeEnvConstants(core.EnvConstants):
    """(common/base.py:103-205)."""

    mujoco_substeps: int = 40
    mujoco_timestep: float = 0.001
    success_threshold_obj_pos: float = 0.04
    success_threshold_obj_rot: float = 0.2
    max_timesteps_per_goal_per_obj: int = 200
    successes_needed: int = 1
    goal_reward_per_object: float = 1.0
    success_pause_range_s: Tuple[float, float] = (0.0, 0.5)
    goal_generation: str = "state"
    stack_fixed_order: bool = False
    goal_args: Tuple[Tuple[str, object], ...] = ()
    stabilize_objects: bool = True
    stabilize_steps: int = 5
    mask_obs_outside_placement_area: bool = False
    vision: bool = False
    vision_image_size: int = 200
    vision_camera_names: Tuple[str, ...] = ("vision_cam_front",)
    vision_mobile_camera_names: Tuple[str, ...] = ("vision_cam_wrist",)
    goal_hide_robot: bool = True


@dataclasses.dataclass(frozen=True)
class RearrangeSimParameters:
    """(simulation/base.py:42-140, the randomizable subset)."""

    num_objects: int = 5
    max_num_objects: int = 8
    object_size: float = 0.0254
    used_table_portion: float = 1.0
    goal_distance_ratio: float = 1.0
    penalty_table_collision: float = 0.0
    penalty_objects_off_table: float = 0.0
    penalty_wrist_collision: float = 0.0
    penalty_safety_stop: float = 0.0
    camera_fovy_radius: float = 0.0
    camera_pos_radius: float = 0.0
    camera_quat_radius: float = 0.0
    light_pos_range: float = 0.0
    light_diffuse_intensity: float = 0.4
    light_ambient_intensity: float = 0.1


@dataclasses.dataclass(frozen=True)
class RearrangeEnvParameters:
    simulation_params: RearrangeSimParameters = dataclasses.field(
        default_factory=RearrangeSimParameters)
    robot_control_params: composite_lib.RobotControlParameters = dataclasses.field(
        default_factory=composite_lib.RobotControlParameters)
    n_random_initial_steps: int = 10
    material_names: Tuple[str, ...] = ()


class BlocksRearrangeEnv:
    """The blocks env on a batch: `reset(batch)`, `step(state, action)`.
    `model` is the compiled main world with `max_num_objects` blocks,
    `solver_model` the mocap world of the mocap_ik dual sim (needed where
    the control parameters ask for it), `settle_model` the objects-only
    world of goal stabilization (needed under `stabilize_goal`: the main
    world's floor, table and blocks), all on the device the env runs on."""

    GOAL_CLASSES = {
        "state": goals_lib.ObjectStateGoal,
        "train": goals_lib.TrainStateGoal,
        "reach": goals_lib.ObjectReachGoal,
        "det-reach": goals_lib.DeterministicReachGoal,
        "stack": goals_lib.ObjectStackGoal,
        "pickandplace": goals_lib.PickAndPlaceGoal,
    }

    def __init__(self, constants: RearrangeEnvConstants, parameters: RearrangeEnvParameters,
                 model: Model, solver_model: Optional[Model] = None, seed: int = 0,
                 settle_model: Optional[Model] = None):
        sp, rcp = parameters.simulation_params, parameters.robot_control_params
        self.parameters = parameters
        dev, dtype = model.device, model.dtype

        def with_timestep(m):
            return m.replace(opt=dataclasses.replace(
                m.opt, timestep=torch.tensor(constants.mujoco_timestep, dtype=dtype, device=dev)))

        self.model = with_timestep(model)
        self.idx = self._index(self.model, "the model")
        self._check_objects()
        self.robot = composite_lib.CompositeIndex.build(self.model, rcp)
        self.action_size = self.robot.action_size
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.constants = dataclasses.replace(
            constants, max_timesteps_per_goal=constants.max_timesteps_per_goal_per_obj
            * sp.num_objects)
        goal_cls = self.GOAL_CLASSES[constants.goal_generation]
        gargs = goals_lib.GoalArgs(**dict(constants.goal_args))
        goal_kw = dict(used_table_portion=sp.used_table_portion, dtype=dtype)
        if constants.goal_generation == "stack":
            goal_kw["fixed_order"] = constants.stack_fixed_order
        if constants.goal_generation == "train":
            goal_kw["goal_distance_ratio"] = sp.goal_distance_ratio
        if constants.goal_generation in ("reach", "det-reach"):
            self.goal_gen = goal_cls(self.idx, self.robot.arm, gargs, **goal_kw)
        else:
            self.goal_gen = goal_cls(self.idx, gargs, **goal_kw)
        self._active = torch.arange(sp.max_num_objects, device=dev) < sp.num_objects
        if gargs.rot_dist_type == "icp":
            # the blocks' corner clouds (O, 8, 3) for the icp rotational distance
            half = np.asarray(sim_lib.geom_bbox_half(self.model, self.idx.object_geom_ids).cpu(),
                              np.float64)
            signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                              for sz in (-1, 1)], np.float32)
            self.goal_gen.icp_verts = torch.as_tensor(half[:, None, :] * signs[None], dtype=dtype,
                                                      device=dev)
        names = parameters.material_names
        if names == ("all",):
            names = tuple(materials_lib.load_all_materials())
        self._material_table = materials_lib.MaterialTable(names) if names else None

        # the objects-only settle world of goal stabilization (blocks.py:208-233);
        # mesh objects settle in the full model (`_settle_in_model`)
        self._settle_model = self._settle_idx = None
        # full-model goal settles run, and the envs they ran on
        self.goal_settles = 0
        self.goal_settle_envs = 0
        types = np.asarray(self.model.const.geom_type)[self.idx.object_geom_ids]
        if gargs.stabilize_goal and not (types == GeomType.MESH).any():
            if settle_model is None:
                raise ValueError("stabilize_goal takes the objects-only settle world "
                                 "(settle_model)")
            self._settle_model = with_timestep(settle_model)
            self._settle_idx = self._index(self._settle_model, "the settle world")
            if not torch.equal(
                    self._settle_model.geom_size[torch.as_tensor(self._settle_idx.object_geom_ids)],
                    self.model.geom_size[torch.as_tensor(self.idx.object_geom_ids)]):
                raise ValueError("the settle world's blocks are not the model's")

        # the mocap_ik solver sim (joint_controlled_tcp_arm.py:12-129): its
        # initial state, the arm at the tabletop pose and the mocap on the TCP
        self._mocap_ik = rcp.requires_solver_sim()
        self.solver_model = self.solver_robot = self._initial_solver_data = None
        if self._mocap_ik:
            if solver_model is None:
                raise ValueError("mocap_ik control takes the solver world (solver_model)")
            self.solver_model = with_timestep(solver_model)
            self.solver_robot = composite_lib.CompositeIndex.build(
                self.solver_model, dataclasses.replace(
                    rcp, tcp_solver_mode=composite_lib.TcpSolverMode.MOCAP))
            sd = make_data(self.solver_model, 1)
            sd = physics.fwd_position(self.solver_model, self._with_tabletop_arm(
                sd, self.solver_robot.arm))
            self._initial_solver_data = tcp_solver.reset_mocap_to_body(
                sd, self.solver_robot.arm.tcp_body_id)

        # the settled initial state (blocks.py:234-262): arm at the tabletop
        # pose, objects parked, 5 x mujoco_substeps substeps
        d0 = self._with_tabletop_arm(make_data(self.model, 1), self.robot.arm)
        O = sp.max_num_objects
        park = torch.as_tensor(sim_lib.PARK_POSITION, dtype=dtype, device=dev)
        pos0 = park + torch.tensor([0.3, 0.0, 0.0], dtype=dtype, device=dev) * torch.arange(
            O, dtype=dtype, device=dev)[:, None]
        quat0 = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev).expand(O, 4)
        d0 = sim_lib.set_object_poses(self.idx, d0, pos0[None], quat0[None])
        if rcp.is_tcp_controlled() and not self._mocap_ik:
            d0 = tcp_solver.reset_mocap_to_body(physics.fwd_position(self.model, d0),
                                                self.robot.arm.tcp_body_id)
        else:
            d0 = d0.replace(ctrl=composite_lib.set_position_control_joint(
                self.robot, self.model, d0, torch.zeros((1, 7), dtype=dtype, device=dev),
                relative_action=True))
        d0 = physics.step_n(self.model, d0, 5 * constants.mujoco_substeps)
        self._initial_data = d0.replace(time=torch.zeros_like(d0.time))

    @property
    def block_half_size(self) -> np.ndarray:
        """(3,) the half-size the world's blocks must have."""
        return np.broadcast_to(self.parameters.simulation_params.object_size, (3,))

    def _check_objects(self) -> None:
        """Raise unless the model's objects are the blocks the parameters
        ask for."""
        half = self.model.geom_size[int(self.idx.object_geom_ids[0])].cpu().numpy()
        if not np.allclose(half, self.block_half_size):
            raise ValueError(f"the model's blocks have half-size {half}, not "
                             f"{self.block_half_size}")

    def _index(self, model: Model, what: str) -> sim_lib.RearrangeIndex:
        O = self.parameters.simulation_params.max_num_objects
        if f"object{O}" in model.const.names["body"]:
            raise ValueError(f"{what} has more than max_num_objects={O} object slots")
        return sim_lib.RearrangeIndex.build(model, O)

    def _with_tabletop_arm(self, d: Data, arm: arm_lib.ArmIndex) -> Data:
        qpos = d.qpos.clone()
        qpos[:, torch.as_tensor(arm.joint_qpos_ids, device=qpos.device)] = torch.as_tensor(
            arm_lib.TABLETOP_EXPERIMENT_INITIAL_POS, dtype=qpos.dtype, device=qpos.device)
        return d.replace(qpos=qpos)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    @property
    def num_objects(self) -> int:
        return self.parameters.simulation_params.num_objects

    @property
    def max_num_objects(self) -> int:
        return self.parameters.simulation_params.max_num_objects

    @property
    def _thresholds(self) -> Dict[str, float]:
        return {"obj_pos": self.constants.success_threshold_obj_pos,
                "obj_rot": self.constants.success_threshold_obj_rot}

    def _num_success(self, dist: Dict[str, torch.Tensor]) -> torch.Tensor:
        """(common/base.py:824-841): objects (every slot) within every
        threshold, times the reward per object."""
        ok = None
        for k, thr in self._thresholds.items():
            ok = dist[k] < thr if ok is None else ok & (dist[k] < thr)
        return ok.sum(-1) * self.constants.goal_reward_per_object

    def _successful(self, dist: Dict[str, torch.Tensor]) -> torch.Tensor:
        ok = None
        for k, thr in self._thresholds.items():
            v = torch.where(self._active, dist[k] < thr, torch.ones_like(dist[k], dtype=torch.bool))
            ok = v.all(-1) if ok is None else ok & v.all(-1)
        return ok

    # ------------------------------------------------------------------
    # draws
    def _u(self, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=self.generator, dtype=self.dtype, device=self.device)

    def draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        """The draws of `reset` for n envs: the group scan's rate (n,), its
        Gumbel noise (n, O, O), the group colours (n, O, 3), the placement's
        candidates (n, O, C, 2) and rotations (n, O), the first goal's
        draws (`goal_gen.draw`), the success hold's (n,) and the soft
        masks' (`_draw_masks`)."""
        O = self.max_num_objects
        tiny = torch.finfo(self.dtype).tiny
        return dict(lam_u=self._u(n),
                    gumbel=-torch.log(-torch.log(torch.clamp(self._u(n, O, O), min=tiny))),
                    color_u=self._u(n, O, 3), place_u=self._u(n, O, goals_lib.N_CANDIDATES, 2),
                    place_rot_u=self._u(n, O),
                    goal=self.goal_gen.draw(self.generator, n, self.num_objects, self.device),
                    pause_u=self._u(n), **self._draw_masks(n), **self._draw_model_fields(n))

    @property
    def vision_params(self) -> vision_rand.VisionRandomizationParams:
        sp = self.parameters.simulation_params
        return vision_rand.VisionRandomizationParams(
            camera_fovy_radius=sp.camera_fovy_radius, camera_pos_radius=sp.camera_pos_radius,
            camera_quat_radius=sp.camera_quat_radius, light_pos_range=sp.light_pos_range,
            light_diffuse_intensity=sp.light_diffuse_intensity,
            light_ambient_intensity=sp.light_ambient_intensity)

    def _draw_model_fields(self, n: int) -> Dict[str, torch.Tensor]:
        """The draws of the per-episode cameras and lights (`vision`, where
        the env randomizes them) and material (`mat_group`: one material a
        group, (n, O)), where the env samples materials."""
        out = {}
        if self.vision_params.any_active():
            out["vision"] = vision_rand.draw_vision(self.generator, n, self.model)
        if self._material_table is not None:
            out["mat_group"] = self._material_table.draw(self.generator, n, self.max_num_objects,
                                                         self.device)
        return out

    def draw_step(self, n: int) -> Dict[str, torch.Tensor]:
        """One step's draws for n envs: the goal resample's, the success
        hold's and the soft masks'."""
        return dict(goal=self.goal_gen.draw(self.generator, n, self.num_objects, self.device),
                    pause_u=self._u(n), **self._draw_masks(n))

    def _draw_masks(self, n: int) -> Dict[str, torch.Tensor]:
        """Under `soft_mask`, one uniform draw per env for the goal's
        placement mask (`goal_mask_u`) and, under
        `mask_obs_outside_placement_area`, one for the observation's
        (`obs_mask_u`)."""
        if not self.goal_gen.args.soft_mask:
            return {}
        out = {"goal_mask_u": self._u(n)}
        if self.constants.mask_obs_outside_placement_area:
            out["obs_mask_u"] = self._u(n)
        return out

    def sample_object_groups(self, lam_u: torch.Tensor, gumbel: torch.Tensor,
                             color_u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each episode's object groups and colours (common/base.py:498-601,
        common/utils.py:45-71): group sizes by a categorical scan with
        logits -size * lam, lam uniform in [1, 8), drawn as argmax(logits +
        gumbel); every object of a group takes its colour. Returns
        (group_ids (B, O), colors (B, O, 4))."""
        B, O = gumbel.shape[:2]
        dev = gumbel.device
        lam = core.uniform_apply(lam_u, 1.0, 8.0)
        sizes = torch.arange(1, O + 1, dtype=lam.dtype, device=dev)
        slots = torch.arange(1, O + 1, device=dev)
        gid = torch.full((B,), -1, dtype=torch.long, device=dev)
        left = torch.zeros((B,), dtype=torch.long, device=dev)
        remaining = torch.full((B,), self.num_objects, dtype=torch.long, device=dev)
        group_ids = []
        for t in range(O):
            start_new = left == 0
            logits = -sizes[None] * lam[:, None]
            logits = torch.where(slots[None] <= torch.clamp(remaining, min=1)[:, None], logits,
                                 torch.full_like(logits, float("-inf")))
            s = 1 + torch.argmax(gumbel[:, t] + logits, dim=-1)
            gid = torch.where(start_new, gid + 1, gid)
            left = torch.where(start_new, s, left)
            remaining = torch.where(start_new, remaining - s, remaining)
            group_ids.append(gid)
            left = left - 1
        group_ids = torch.stack(group_ids, dim=1)
        palette = torch.cat([color_u, torch.ones_like(color_u[..., :1])], dim=-1)
        colors = torch.gather(palette, 1, torch.clamp(group_ids, 0, O - 1)[..., None].expand(
            -1, -1, 4))
        return group_ids, colors

    def _reset_model_fields(self, draws: Dict[str, torch.Tensor], batch: int):
        """Each episode's model fields (blocks.py:348-382): its objects'
        colours from their groups. Returns (fields, the objects' half-sizes
        (O, 3) or (B, O, 3), group ids (B, O))."""
        group_ids, colors = self.sample_object_groups(draws["lam_u"], draws["gumbel"],
                                                      draws["color_u"])
        oid = torch.as_tensor(self.idx.object_geom_ids, device=self.device)
        rgba = self.model.geom_rgba.expand((batch,) + tuple(self.model.geom_rgba.shape)).clone()
        rgba[:, oid] = colors.to(rgba.dtype)
        fields = {"geom_rgba": rgba}
        if "vision" in draws:
            fields.update(vision_rand.apply_vision(self.model, draws["vision"],
                                                   self.vision_params))
        if self._material_table is not None:
            # one material a group (common/base.py:568-585), gathered per object
            O = self.max_num_objects
            mat_idx = torch.gather(draws["mat_group"], 1, torch.clamp(group_ids, 0, O - 1))
            fields.update(self._material_table.model_fields(
                self.model, self.idx.object_geom_ids, self.idx.object_body_ids, mat_idx))
        return fields, sim_lib.geom_bbox_half(self.model, self.idx.object_geom_ids), group_ids

    def _in_placement_area(self, pos: torch.Tensor, u: Optional[torch.Tensor]) -> torch.Tensor:
        args = self.goal_gen.args
        return sim_lib.in_placement_area(
            self.idx, pos, self.num_objects, self.parameters.simulation_params.used_table_portion,
            args.mask_margin, self._active, soft=args.soft_mask, u=u)

    def _stabilize_goal(self, goal: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The goal's objects dropped at their goal poses into the settle
        world and settled (blocks.py:647-672); their rested poses are the
        goal. As in the JAX package the settle world keeps its compiled
        model: each env's model fields do not reach it."""
        n_sub = self.constants.stabilize_steps * self.constants.mujoco_substeps
        sm, sidx = self._settle_model, self._settle_idx
        dg = sim_lib.set_object_poses(sidx, make_data(sm, goal["obj_pos"].shape[0]),
                                      goal["obj_pos"], goal["obj_rot"])
        dg = physics.step_n(sm, dg, n_sub)
        return dict(goal, obj_pos=sim_lib.object_positions(sidx, dg),
                    obj_rot=sim_lib.object_quats(sidx, dg))

    def _settle_in_model(self, goal: Dict[str, torch.Tensor], m: Model, d: Data,
                         envs: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The goal settle of mesh objects (blocks.py:673-680): the objects
        teleported to their goal poses in each env's own state, arm
        included, the full model stepped under each env's own model fields,
        the rested poses read back. Only on the envs `envs` (k,) (all where
        None), gathered, their results scattered back; none runs where
        `envs` is empty."""
        if envs is None:
            envs = torch.arange(d.qpos.shape[0], device=d.qpos.device)
        if not envs.numel():
            return goal
        self.goal_settles += 1
        self.goal_settle_envs += int(envs.numel())
        n_sub = self.constants.stabilize_steps * self.constants.mujoco_substeps
        dg = sim_lib.set_object_poses(self.idx, core.data_map(lambda x: x[envs], d),
                                      goal["obj_pos"][envs], goal["obj_rot"][envs])
        dg = physics.step_n(core.take_model_envs(m, envs), dg, n_sub)
        rested = {"obj_pos": sim_lib.object_positions(self.idx, dg),
                  "obj_rot": sim_lib.object_quats(self.idx, dg)}
        return dict(goal, **{k: goal[k].index_put((envs,), v.to(goal[k].dtype))
                             for k, v in rested.items()})

    def _next_goal(self, draws, sizes, group_ids, d: Data, m: Optional[Model] = None,
                   envs: Optional[torch.Tensor] = None):
        """A new goal for every env (blocks.py:413-418, :596-606), settled
        under `stabilize_goal` (mesh objects in the model `m`, on the envs
        `envs`: `_settle_in_model`), with goal_objects_in_placement_area /
        goal_in_placement_area (goals/object_state.py:376-405) and the
        episode's groups."""
        goal = self.goal_gen.next_goal(draws["goal"], self._active, sizes, self.num_objects, d)
        if self.goal_gen.args.stabilize_goal:
            goal = (self._stabilize_goal(goal) if self._settle_model is not None
                    else self._settle_in_model(goal, m, d, envs))
        inside = self._in_placement_area(goal["obj_pos"], draws.get("goal_mask_u"))
        return dict(goal, goal_objects_in_placement_area=inside,
                    goal_in_placement_area=inside.all(-1), group_ids=group_ids)

    # ------------------------------------------------------------------
    # env API
    def reset(self, batch: int, draws: Optional[Dict[str, torch.Tensor]] = None
              ) -> Tuple[core.EnvState, Dict[str, torch.Tensor]]:
        """`batch` new episodes (blocks.py:384-438): (state, obs). `draws`
        as `draw_reset` gives them, by default from the env's generator."""
        cst, sp = self.constants, self.parameters.simulation_params
        draws = draws if draws is not None else self.draw_reset(batch)
        O = self.max_num_objects
        fields, sizes, group_ids = self._reset_model_fields(draws, batch)

        d = core.data_map(lambda x: x.expand((batch,) + x.shape[1:]).clone(), self._initial_data)
        pos, _ = goals_lib.sample_goal_positions(draws["place_u"], self.idx, self._active, sizes,
                                                 self.num_objects, sp.used_table_portion)
        quat = goals_lib.sample_goal_rotations(draws["place_rot_u"], batch, O,
                                               goals_lib.GoalArgs(randomize_goal_rot=True),
                                               self.dtype, self.device)
        d = sim_lib.set_object_poses(self.idx, d, pos, quat)
        m = core.apply_model_fields(self.model, fields)
        if cst.stabilize_objects:
            d = physics.step_n(m, d, cst.stabilize_steps * cst.mujoco_substeps)
        else:
            d = physics.fwd_position(m, d)

        goal = self._next_goal(draws, sizes, group_ids, d, m)
        tracker = core.TrackerState.zero(batch, device=self.device).replace(
            success_steps_required=core.sample_success_steps_required(draws["pause_u"], cst))
        goal_aux = (core.data_map(lambda x: x.expand((batch,) + x.shape[1:]).clone(),
                                  self._initial_solver_data) if self._mocap_ik
                    else torch.zeros(batch, dtype=self.dtype, device=self.device))
        state = core.EnvState(
            physics=d, goal=goal, goal_aux=goal_aux,
            prev_goal_distance=self.goal_gen.goal_distance(goal, d, self._active),
            tracker=tracker, t=torch.zeros(batch, dtype=torch.int32, device=self.device),
            model_fields=fields, robot_aux=self._initial_regrasp(d))
        return state, self._observe(state, draws.get("obs_mask_u"))

    def _initial_regrasp(self, d: Data):
        """A fresh regrasp state where regrasp is on
        (mujoco_robotiq_gripper.py:62-68), else None."""
        if not self.parameters.robot_control_params.enable_gripper_regrasp:
            return None
        g = self.robot.gripper
        return gripper_lib.init_regrasp(d.qpos[:, g.joint_qpos_id], d.ctrl[:, g.actuator_id])

    def _tcp_wrench(self, m: Model, d: Data):
        return sim_lib.contact_wrench_on_geoms(self.idx.gripper_geom_ids,
                                               arm_lib.tcp_xyz(self.robot.arm, d), m, d)

    def _dual_sim(self, m: Model, d: Data, solver_d: Data, arm_action: torch.Tensor):
        """The mocap_ik dual sim (joint_controlled_tcp_arm.py:90-129): the
        solver arm synced to the main sim's joints (under
        arm_reset_controller_error) and its gripper to the main gripper,
        positioned, its mocap moved by the TCP action, stepped; its joint
        positions become the main arm's targets. Returns (main ctrl,
        solver Data)."""
        cst, rcp = self.constants, self.parameters.robot_control_params
        sm, sarm, sgrip = self.solver_model, self.solver_robot.arm, self.solver_robot.gripper
        arm, grip = self.robot.arm, self.robot.gripper
        sq = solver_d.qpos.clone()
        if rcp.arm_reset_controller_error:
            sq[:, torch.as_tensor(sarm.joint_qpos_ids, device=sq.device)] = \
                arm_lib.joint_positions(arm, d)
        sq[:, sgrip.joint_qpos_id] = d.qpos[:, grip.joint_qpos_id]
        sctrl = solver_d.ctrl.clone()
        sctrl[:, sgrip.actuator_id] = d.ctrl[:, grip.actuator_id]
        solver_d = physics.fwd_position(sm, solver_d.replace(qpos=sq, ctrl=sctrl))
        solver_d = tcp_solver.tcp_set_position_control(
            sm, solver_d, sarm.tcp_body_id, arm_action, rcp.control_mode,
            rcp.default_max_position_change())
        solver_d = physics.step_n(sm, solver_d, cst.mujoco_substeps)
        aids = torch.as_tensor(arm.actuator_ids, device=d.ctrl.device)
        cr = m.take("actuator_ctrlrange", aids)
        ctrl = d.ctrl.clone()
        ctrl[:, aids] = torch.minimum(torch.maximum(
            arm_lib.joint_positions(sarm, solver_d).to(ctrl.dtype), cr[..., 0]), cr[..., 1])
        return ctrl, solver_d

    def step(self, state: core.EnvState, action: torch.Tensor,
             draws: Optional[Dict[str, torch.Tensor]] = None):
        """One env step for the batch (blocks.py:450-645): (state, obs,
        reward (B, 3), done (B,), info). `action` (B, action_size) in
        [-1, 1]; `draws` as `draw_step` gives them (by default from the
        env's generator), used where an env's goal resamples."""
        cst, sp = self.constants, self.parameters.simulation_params
        rcp = self.parameters.robot_control_params
        m = core.apply_model_fields(self.model, state.model_fields)
        action = torch.clamp(action, -1.0, 1.0).to(self.dtype)
        d, solver_d = state.physics, state.goal_aux
        arm_action = action[:, :-1]
        if self._mocap_ik and rcp.use_force_limiter:
            tcp_f, tcp_t = self._tcp_wrench(m, d)
            scales, _ = limiter.get_element_wise_tcp_control_limits(
                torch.cat([torch.abs(tcp_f), torch.abs(tcp_t)], dim=-1))
            n_rot = self.action_size - 4
            arm_action = arm_action * torch.cat([scales[:, :3], scales[:, 3:3 + n_rot]],
                                                dim=-1).to(arm_action.dtype)
        if self._mocap_ik:
            ctrl, solver_d = self._dual_sim(m, d, solver_d, arm_action)
            ctrl = gripper_lib.denormalize_position_control(
                self.robot.gripper, m, d.replace(ctrl=ctrl), action[:, -1:],
                relative_action=cst.relative_action)
        elif rcp.is_tcp_controlled():
            d = tcp_solver.tcp_set_position_control(m, d, self.robot.arm.tcp_body_id, arm_action,
                                                    rcp.control_mode,
                                                    rcp.default_max_position_change())
            ctrl = gripper_lib.denormalize_position_control(self.robot.gripper, m, d,
                                                            action[:, -1:],
                                                            relative_action=cst.relative_action)
        else:
            ctrl = composite_lib.set_position_control_joint(self.robot, m, d, action,
                                                            relative_action=cst.relative_action)
        robot_aux = state.robot_aux
        if robot_aux is not None and cst.relative_action:
            g = self.robot.gripper
            out, robot_aux = gripper_lib.compute_regrasp_control(
                robot_aux, action[:, -1], ctrl[:, g.actuator_id], d.qpos[:, g.joint_qpos_id])
            ctrl = ctrl.clone()
            ctrl[:, g.actuator_id] = out
        d = physics.step_n(m, d.replace(ctrl=ctrl), cst.mujoco_substeps)
        d, crashed = core.divergence_guard(state.physics, d)

        dist = self.goal_gen.goal_distance(state.goal, d, self._active)
        goal_distance_reward = self._num_success(dist) - self._num_success(state.prev_goal_distance)
        successful = self._successful(dist)
        tracker, success_reward, done, need_new_goal = core.tracker_process(
            state.tracker, cst, successful, torch.zeros_like(successful))

        # penalties and off-table termination (common/base.py:768-795)
        off_table = sim_lib.check_objects_off_table(
            self.idx, sim_lib.object_positions(self.idx, d), active_mask=self._active)
        any_off = off_table.any(-1)
        done = done | any_off
        table_contact = sim_lib.gripper_table_contact(self.idx, m, d)
        tcp_force, _ = self._tcp_wrench(m, d)
        in_safety_stop = rot.norm(tcp_force) > arm_lib.SAFETY_STOP_FORCE_THRESHOLD
        zero = torch.zeros_like(goal_distance_reward, dtype=self.dtype)
        env_reward = (zero - torch.where(any_off, sp.penalty_objects_off_table, 0.0)
                      - torch.where(table_contact, sp.penalty_table_collision, 0.0)
                      - torch.where(in_safety_stop, sp.penalty_safety_stop, 0.0)).to(self.dtype)

        # the goal resample, drawn for every env, taken where need_new_goal
        # (the full-model settle runs on those envs only)
        draws = draws if draws is not None else self.draw_step(d.qpos.shape[0])
        sizes = sim_lib.geom_bbox_half(m, self.idx.object_geom_ids)
        new = self._next_goal(draws, sizes, state.goal["group_ids"], d, m,
                              torch.nonzero(need_new_goal).flatten())
        goal = {k: torch.where(need_new_goal.view((-1,) + (1,) * (v.dim() - 1)), new[k], v)
                for k, v in state.goal.items()}
        tracker = tracker.replace(
            success_steps_required=torch.where(
                need_new_goal, core.sample_success_steps_required(draws["pause_u"], cst),
                tracker.success_steps_required),
            consecutive_successes=torch.where(
                need_new_goal, torch.zeros_like(tracker.consecutive_successes),
                tracker.consecutive_successes))
        resampled = self.goal_gen.goal_distance(goal, d, self._active)
        dist_after = {k: torch.where(need_new_goal[:, None], resampled[k], v)
                      for k, v in dist.items()}

        new_state = core.EnvState(
            physics=d, goal=goal, goal_aux=solver_d if self._mocap_ik else state.goal_aux,
            prev_goal_distance=dist_after, tracker=tracker, t=state.t + 1,
            model_fields=state.model_fields, robot_aux=robot_aux)
        reward = torch.stack([env_reward, goal_distance_reward.to(self.dtype),
                              success_reward.to(self.dtype)], dim=-1)
        done = done | crashed
        info = {"env_crash": crashed, "objects_off_table": off_table,
                "gripper_table_contact": table_contact, "is_successful": successful}
        info.update(core.tracker_info(tracker, cst))
        return new_state, self._observe(new_state, draws.get("obs_mask_u")), reward, done, info

    def _observe(self, state: core.EnvState,
                 mask_u: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """The observation map without vision (common/base.py:376-421),
        padded to max_num_objects; with the masked observations under
        `mask_obs_outside_placement_area` (`mask_u` (B,) the soft mask's
        draw)."""
        d = state.physics
        B = d.qpos.shape[0]
        m = core.apply_model_fields(self.model, state.model_fields)
        obj_pos = sim_lib.object_positions(self.idx, d)
        obj_quat = sim_lib.object_quats(self.idx, d)
        obj_vel = sim_lib.object_velocities(self.idx, d)
        mask = self._active[:, None].to(self.dtype)
        tcp = arm_lib.tcp_xyz(self.robot.arm, d)
        dist = self.goal_gen.goal_distance(state.goal, d, self._active)
        rel_goal = self.goal_gen.relative_goal(state.goal, d, self._active)
        tcp_force, tcp_torque = sim_lib.contact_wrench_on_geoms(self.idx.gripper_geom_ids, tcp, m,
                                                                d)
        safety_stop = rot.norm(tcp_force) > arm_lib.SAFETY_STOP_FORCE_THRESHOLD
        oid = torch.as_tensor(self.idx.object_geom_ids, device=self.device)
        g = self.robot.gripper
        obs = {
            "obj_pos": obj_pos * mask,
            "obj_rel_pos": (obj_pos - tcp[:, None, :]) * mask,
            "obj_rot": rot.quat2euler(obj_quat) * mask,
            "obj_vel_pos": obj_vel[..., 3:] * mask,
            "obj_vel_rot": obj_vel[..., :3] * mask,
            "goal_obj_pos": state.goal["obj_pos"] * mask,
            "goal_obj_rot": rot.quat2euler(state.goal["obj_rot"]) * mask,
            "rel_goal_obj_pos": rel_goal["obj_pos"] * mask,
            "rel_goal_obj_rot": rel_goal["obj_rot"] * mask,
            "obj_colors": m.take("geom_rgba", oid).expand(B, -1, -1) * mask,
            "obj_bbox_size": m.take("geom_size", oid).expand(B, -1, -1) * mask,
            "obj_gripper_contact": sim_lib.object_gripper_contact(self.idx, d).to(self.dtype)
            * mask,
            "gripper_pos": tcp,
            "gripper_velp": arm_lib.tcp_vel(self.robot.arm, m, d),
            "gripper_controls": d.ctrl[:, g.actuator_id][:, None],
            "gripper_qpos": gripper_lib.joint_position(g, d),
            "gripper_vel": gripper_lib.joint_velocity(g, d),
            "qpos": d.qpos,
            "qpos_goal": sim_lib.goal_qpos(self.idx, d, state.goal["obj_pos"],
                                           state.goal["obj_rot"]),
            "robot_joint_pos": arm_lib.joint_positions(self.robot.arm, d),
            "tcp_force": tcp_force.to(self.dtype),
            "tcp_torque": tcp_torque.to(self.dtype),
            "safety_stop": safety_stop.to(self.dtype)[:, None],
            "is_goal_achieved": self._successful(dist).to(self.dtype)[:, None],
        }
        if self.constants.mask_obs_outside_placement_area:
            obs.update(self._masked_obs(state, obs, obj_pos, mask_u))
        if self.constants.vision:
            obs.update(self._observe_vision(m, d, obs["qpos_goal"]))
        return obs

    def _observe_vision(self, m: Model, d: Data, qpos_goal: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        """`vision_obs` and `vision_obs_mobile`, the fixed and the wrist
        cameras' images of the state, and `vision_goal`, the fixed cameras'
        of the goal state (the objects at their goals, positioned) with the
        robot hidden (common/base.py:230-296)."""
        cst = self.constants
        size = cst.vision_image_size
        out = {"vision_obs": vision_lib.render_cameras(m, d, cst.vision_camera_names, size),
               "vision_obs_mobile": vision_lib.render_cameras(
                   m, d, cst.vision_mobile_camera_names, size)}
        d_goal = physics.fwd_position(m, d.replace(qpos=qpos_goal))
        vis = (vision_lib.robot_hidden_mask(m, ("robot0:",) + tuple(self.idx.GRIPPER_BODIES))
               if cst.goal_hide_robot else None)
        out["vision_goal"] = vision_lib.render_cameras(m, d_goal, cst.vision_camera_names, size,
                                                       geom_visible=vis)
        return out

    def _masked_obs(self, state: core.EnvState, obs: Dict[str, torch.Tensor],
                    obj_pos: torch.Tensor, mask_u: Optional[torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
        """placement_mask, goal_placement_mask (B, O, 1) and the masked_*
        observations of objects and goals outside the placement area
        (common/base.py:311-374); padding slots mask to 1."""
        pmask = self._in_placement_area(obj_pos, mask_u).to(self.dtype)[..., None]
        gmask = state.goal["goal_objects_in_placement_area"].to(self.dtype)[..., None]
        out = {"placement_mask": pmask, "goal_placement_mask": gmask}
        for k in ("obj_pos", "obj_rot", "obj_rel_pos", "obj_vel_pos", "obj_vel_rot",
                  "obj_gripper_contact", "obj_bbox_size", "obj_colors"):
            out["masked_" + k] = obs[k] * pmask
        for k in ("goal_obj_pos", "goal_obj_rot", "rel_goal_obj_pos", "rel_goal_obj_rot"):
            out["masked_" + k] = obs[k] * gmask
        return out


def _load(path: str, device) -> Model:
    with np.load(path) as z:
        return bridge.model_from_numpy({k: z[k] for k in z.files}, device)


def configs(constants: Optional[dict], parameters: Optional[dict],
            constants_cls=RearrangeEnvConstants, parameters_cls=RearrangeEnvParameters,
            **sim_defaults):
    """(constants, parameters) from the dicts `make_env` takes, the
    simulation parameters' defaults updated by `sim_defaults`."""
    cst_kw = dict(constants or {})
    if isinstance(cst_kw.get("goal_args"), dict):
        cst_kw["goal_args"] = tuple(sorted(cst_kw["goal_args"].items()))
    par_kw = dict(parameters or {})
    sp = RearrangeSimParameters(**{**sim_defaults, **par_kw.pop("simulation_params", {})})
    rcp = composite_lib.RobotControlParameters(**(par_kw.pop("robot_control_params", None) or {}))
    return constants_cls(**cst_kw), parameters_cls(simulation_params=sp, robot_control_params=rcp,
                                                   **par_kw)


def load_worlds(constants: RearrangeEnvConstants, parameters: RearrangeEnvParameters, device,
                main: Optional[str] = None) -> Dict[str, Model]:
    """The compiled worlds an env takes, from the committed snapshots on
    `device`: the main world `main` (by default the 8-block world, with
    the vision cameras where the env renders them), the solver world where
    the control needs the mocap_ik dual sim, and the 8-block settle world
    under `stabilize_goal`."""
    if main is None:
        main = vision_like.REARRANGE_SNAPSHOT if constants.vision else \
            rearrange_blocks_like.SNAPSHOT
    out = {"model": _load(main, device)}
    if parameters.robot_control_params.requires_solver_sim():
        out["solver_model"] = _load(rearrange_blocks_like.SOLVER_SNAPSHOT, device)
    if goals_lib.GoalArgs(**dict(constants.goal_args)).stabilize_goal:
        out["settle_model"] = _load(rearrange_blocks_like.SETTLE_SNAPSHOT, device)
    return out


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             device="cuda", seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> BlocksRearrangeEnv:
    """The blocks env on `device` (the card unless the caller asks for the
    CPU), as the JAX package's `make_env(constants, parameters)` builds it,
    its draws seeded by `seed`; on the compiled `worlds` ({"model",
    "solver_model", "settle_model"}, each where the env needs it; by
    default `load_worlds`' snapshots, whose main world has 8 object slots
    of half-size 0.0254)."""
    cst, par = configs(constants, parameters)
    return BlocksRearrangeEnv(cst, par, seed=seed, **(worlds or load_worlds(cst, par, device)))
