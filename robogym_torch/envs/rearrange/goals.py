"""Rearrange goal generation, batched: free placements of every object
(`ObjectStateGoal`, the blocks env's default "state" goals) and the goal
classes built on them (train, reach, deterministic reach, stack,
pick-and-place, fixed placements, dominos), rotational distances and the
greedy matching of duplicate objects to goals.

Counterpart of `robogym_tpu/envs/rearrange/goals.py`. Every random function
takes its draws from the caller: `sample_goal_positions` its `(B, O, 20,
2)` candidates, `sample_goal_rotations` one draw per object for "z_axis",
three for "full", or one and a cube rotation's index for "block". Each goal class draws what its `next_goal` takes with
`draw(gen, B, num_objects_used, device)`, one dict per call: uniform
draws in [0, 1) in the goal's dtype, integer draws (an object index, a
tower size, a permutation of the object slots) as long tensors. Where the
JAX package reuses a key for two draws (`TrainStateGoal`'s lift height and
lifted object, `DeterministicReachGoal`'s candidates and pool index), the
port takes two draws; its tests feed both from the one key.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from robogym_torch.envs.core import uniform_apply
from robogym_torch.envs.rearrange import simulation as sim_lib
from robogym_torch.mjcf.model import Data
from robogym_torch.robot import ur16e as arm_lib
from robogym_torch.utils import icp as icp_lib
from robogym_torch.utils import rotation as rot

N_CANDIDATES = 20


@dataclasses.dataclass(frozen=True)
class GoalArgs:
    """(goals/object_state.py:122-170, the JAX package's subset)."""

    randomize_goal_rot: bool = False
    rot_randomize_type: str = "z_axis"   # z_axis | block | full
    stabilize_goal: bool = False
    rot_dist_type: str = "full"          # full | mod90 | mod180 | icp
    icp_max_num_vertices: int = 500
    mask_margin: float = 0.02
    soft_mask: bool = False
    height_range: Tuple[float, float] = (0.05, 0.25)
    pickup_proba: float = 0.0
    stacking_proba: float = 0.0


def sample_goal_positions(u: torch.Tensor, idx: sim_lib.RearrangeIndex,
                          active_mask: torch.Tensor, object_size: torch.Tensor,
                          num_objects_used: int, used_table_portion: float = 1.0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-overlapping placements in the placement area by rejection
    (common/utils.py:832-883): object after object, the first of its
    candidates (u (B, O, C, 2) uniform in [0, 1), mapped into the area
    less its half-size) whose xy box overlaps no earlier object's; an
    inactive slot parks off the table. `object_size` (O, 3) or (B, O, 3)
    half-sizes. Returns ((B, O, 3) positions, (B,) every active object
    found a free candidate)."""
    B, O = u.shape[:2]
    dtype, dev = u.dtype, u.device
    lo, hi = idx.placement_bounds(num_objects_used, used_table_portion)
    _, _, table_height = idx.table_dimensions()
    lo = torch.as_tensor(lo, dtype=dtype, device=dev)
    hi = torch.as_tensor(hi, dtype=dtype, device=dev)
    size = object_size.to(dtype).expand(B, O, 3)
    park = torch.as_tensor(sim_lib.PARK_POSITION, dtype=dtype, device=dev)
    step = torch.tensor([0.3, 0.0, 0.0], dtype=dtype, device=dev)
    placed = torch.zeros((B, O, 3), dtype=dtype, device=dev)
    valid = torch.ones(B, dtype=torch.bool, device=dev)
    for i in range(O):
        s = size[:, i]                                                   # (B, 3)
        cand = uniform_apply(u[:, i], (lo[:2] + s[:, :2])[:, None], (hi[:2] - s[:, :2])[:, None])
        delta = torch.abs(cand[:, :, None, :] - placed[:, None, :i, :2])   # (B, C, i, 2)
        sizes_sum = s[:, None, None, :2] + size[:, None, :i, :2]
        ok = ~(delta < sizes_sum).all(-1).any(-1)                        # (B, C)
        pick = torch.argmax(ok.to(torch.uint8), dim=-1)
        found = torch.gather(ok, 1, pick[:, None])[:, 0]
        xy = torch.gather(cand, 1, pick[:, None, None].expand(-1, 1, 2))[:, 0]
        z = torch.as_tensor(table_height, dtype=dtype, device=dev) + s[:, 2:3]
        pos = torch.where(active_mask[i], torch.cat([xy, z], -1), (park + step * i).expand(B, 3))
        placed = placed.clone()
        placed[:, i] = pos
        valid = valid & (found | ~active_mask[i])
    return placed, valid


def sample_goal_rotations(u: Optional[torch.Tensor], B: int, O: int, args: GoalArgs,
                          dtype=torch.float32, device=None,
                          choice: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, O, 4) object rotations: identity unless `args.randomize_goal_rot`,
    else about z from u (B, O) ("z_axis"), uniform from u (B, O, 3)
    ("full"), or about z from u (B, O) times the cube rotation
    `PARALLEL_QUATS`[choice] (choice (B, O) in [0, 24), "block"), each
    computed in u's dtype and cast to `dtype`."""
    if not args.randomize_goal_rot:
        q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
        return q.expand(B, O, 4).clone()
    if args.rot_randomize_type == "z_axis":
        return rot.uniform_z_quat_apply(u).to(dtype)
    if args.rot_randomize_type == "full":
        return rot.uniform_quat_apply(u).to(dtype)
    if args.rot_randomize_type == "block":
        parallel = torch.as_tensor(rot.get_parallel_rotations(), dtype=dtype, device=u.device)
        return rot.quat_mul(rot.uniform_z_quat_apply(u).to(dtype), parallel[choice])
    raise ValueError(f"rot_randomize_type {args.rot_randomize_type!r}")


def _symmetry_quats(dist_type: str, like: torch.Tensor) -> torch.Tensor:
    sym = rot.get_parallel_rotations_180() if dist_type == "mod180" else \
        rot.get_parallel_rotations()
    return torch.as_tensor(sym, dtype=like.dtype, device=like.device)


def rot_distance(q1: torch.Tensor, q2: torch.Tensor, dist_type: str = "full",
                 verts: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., O) rotational distance of quats (..., O, 4): the full quat
    distance, its minimum over the box's symmetries ("mod90": the 24 cube
    rotations, "mod180": the 4 made of multiples of pi), or the angle of
    the rotation ICP finds between each object's vertex cloud (`verts` (O,
    V, 3) in the object's frame) turned by q1 and by q2 ("icp")."""
    if dist_type == "full":
        return rot.quat_magnitude(rot.quat_normalize(rot.quat_difference(q1, q2)))
    if dist_type == "icp":
        if verts is None:
            raise ValueError("the icp rotational distance takes the objects' vertex clouds")
        return icp_lib.icp_rotation_distance(verts.to(q1.dtype), q1, q2)
    if dist_type not in ("mod90", "mod180"):
        raise ValueError(f"rot_dist_type {dist_type!r}")
    sym = _symmetry_quats(dist_type, q1)
    cands = rot.quat_magnitude(rot.quat_normalize(rot.quat_difference(
        rot.quat_mul(q1[..., None, :], sym), q2[..., None, :])))
    return cands.amin(-1)


def relative_rot_euler(q_goal: torch.Tensor, q_cur: torch.Tensor,
                       dist_type: str = "full") -> torch.Tensor:
    """(..., O, 3) each object's rotation to its goal as euler angles, after
    the symmetry reduction of `dist_type` (goals/object_state.py:196-201);
    "icp" reports the full difference, as the JAX package does."""
    if dist_type in ("full", "icp"):
        return rot.quat2euler(rot.quat_normalize(rot.quat_difference(q_goal, q_cur)))
    if dist_type not in ("mod90", "mod180"):
        raise ValueError(f"rot_dist_type {dist_type!r}")
    sym = _symmetry_quats(dist_type, q_goal)
    diffs = rot.quat_normalize(rot.quat_difference(rot.quat_mul(q_goal[..., None, :], sym),
                                                   q_cur[..., None, :]))
    best = torch.argmin(rot.quat_magnitude(diffs), dim=-1)
    pick = torch.gather(diffs, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    return rot.quat2euler(pick)


def greedy_group_match(obj_pos: torch.Tensor, goal_pos: torch.Tensor, group_ids: torch.Tensor,
                       active_mask: torch.Tensor) -> torch.Tensor:
    """(B, O) goal index of each object: O rounds of taking the closest
    (object, goal) pair of one group and retiring its row and column
    (goals/object_state.py:520-560); identity where nothing matched."""
    B, O = obj_pos.shape[:2]
    dev = obj_pos.device
    cost = rot.norm(obj_pos[:, :, None, :] - goal_pos[:, None, :, :])
    valid = ((group_ids[:, :, None] == group_ids[:, None, :])
             & active_mask[None, :, None] & active_mask[None, None, :])
    inf = torch.full_like(cost, float("inf"))
    cost = torch.where(valid, cost, inf)
    iota = torch.arange(O, device=dev)
    match = iota.expand(B, O).clone()
    for _ in range(O):
        flat = torch.argmin(cost.reshape(B, -1), dim=-1)
        i, j = flat // O, flat % O
        ok = torch.isfinite(torch.gather(cost.reshape(B, -1), 1, flat[:, None])[:, 0])
        match = torch.where(ok[:, None] & (iota[None] == i[:, None]), j[:, None], match)
        retire = (iota[None, :, None] == i[:, None, None]) | (iota[None, None, :] == j[:, None, None])
        cost = torch.where(ok[:, None, None] & retire, inf, cost)
    return match


class ObjectStateGoal:
    """Free-placement position (and rotation) goals
    (goals/object_state.py:173-599): `next_goal` on the caller's draws,
    distances and relative goals as functions of (goal, Data)."""

    def __init__(self, idx: sim_lib.RearrangeIndex, args: GoalArgs = GoalArgs(),
                 used_table_portion: float = 1.0, dtype=torch.float32):
        self.idx = idx
        # (O, V, 3) the objects' vertex clouds in their frames, for the icp
        # rotational distance (the env sets them)
        self.icp_verts: Optional[torch.Tensor] = None
        self.args = args
        self.used_table_portion = used_table_portion
        self.dtype = dtype

    def _u(self, gen: torch.Generator, device, *shape) -> torch.Tensor:
        return torch.rand(shape, generator=gen, dtype=self.dtype, device=device)

    def _perm(self, gen: torch.Generator, B: int, device) -> torch.Tensor:
        """(B, O) a random permutation of the object slots in each env."""
        return torch.argsort(self._u(gen, device, B, self.idx.max_num_objects), dim=-1)

    def draw(self, gen: torch.Generator, B: int, num_objects_used: int,
             device=None) -> Dict[str, torch.Tensor]:
        """The draws of `next_goal` for B envs: candidates (B, O, C, 2) and,
        where goals randomize rotations, their draws."""
        O = self.idx.max_num_objects
        out = {"pos_u": self._u(gen, device, B, O, N_CANDIDATES, 2), "rot_u": None}
        if self.args.randomize_goal_rot:
            shape = (B, O, 3) if self.args.rot_randomize_type == "full" else (B, O)
            out["rot_u"] = self._u(gen, device, *shape)
            if self.args.rot_randomize_type == "block":
                out["rot_choice"] = torch.randint(0, len(rot.get_parallel_rotations()), (B, O),
                                                  generator=gen, device=device)
        return out

    def next_goal(self, draws: Dict[str, torch.Tensor], active_mask: torch.Tensor,
                  object_size: torch.Tensor, num_objects_used: int,
                  d: Data) -> Dict[str, torch.Tensor]:
        """A goal for each env from `draws` (see `draw`); `object_size` the
        objects' half-sizes, (O, 3) or each env's own (B, O, 3); `d` the
        state the goal is drawn in."""
        pos, valid = sample_goal_positions(draws["pos_u"], self.idx, active_mask, object_size,
                                           num_objects_used, self.used_table_portion)
        quat = sample_goal_rotations(draws["rot_u"], pos.shape[0], self.idx.max_num_objects,
                                     self.args, self.dtype, pos.device, draws.get("rot_choice"))
        return {"obj_pos": pos, "obj_rot": quat, "goal_valid": valid}

    def _match(self, goal: Dict[str, torch.Tensor], cur_pos: torch.Tensor,
               active_mask: torch.Tensor) -> torch.Tensor:
        """Each object's goal index: greedy within duplicate-object groups
        where the goal carries `group_ids`, else itself."""
        if "group_ids" in goal:
            return greedy_group_match(cur_pos, goal["obj_pos"], goal["group_ids"], active_mask)
        B, O = cur_pos.shape[:2]
        return torch.arange(O, device=cur_pos.device).expand(B, O)

    @staticmethod
    def _take(x: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
        return torch.gather(x, 1, match[..., None].expand(match.shape + x.shape[2:]))

    def relative_goal(self, goal: Dict[str, torch.Tensor], d: Data,
                      active_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """rel_goal_obj_pos / rel_goal_obj_rot (B, O, 3) after matching
        (goals/object_state.py:492-584)."""
        cur_pos = sim_lib.object_positions(self.idx, d)
        cur_quat = sim_lib.object_quats(self.idx, d)
        match = self._match(goal, cur_pos, active_mask)
        mask = active_mask.to(cur_pos.dtype)[:, None]
        rel_rot = relative_rot_euler(self._take(goal["obj_rot"], match), cur_quat,
                                     self.args.rot_dist_type)
        return {"obj_pos": (self._take(goal["obj_pos"], match) - cur_pos) * mask,
                "obj_rot": rot.normalize_angles(rel_rot) * mask}

    def goal_distance(self, goal: Dict[str, torch.Tensor], d: Data,
                      active_mask: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{"obj_pos", "obj_rot"}, each (B, O), zero at inactive slots; the
        rotational distance is zero unless goals randomize rotations."""
        cur_pos = sim_lib.object_positions(self.idx, d)
        cur_quat = sim_lib.object_quats(self.idx, d)
        match = self._match(goal, cur_pos, active_mask)
        pos_dist = rot.norm(self._take(goal["obj_pos"], match) - cur_pos)
        mask = active_mask.to(pos_dist.dtype)
        out = {"obj_pos": pos_dist * mask}
        if self.args.randomize_goal_rot:
            rdist = rot_distance(self._take(goal["obj_rot"], match), cur_quat,
                                 self.args.rot_dist_type, self.icp_verts)
            out["obj_rot"] = rdist * mask
        else:
            out["obj_rot"] = torch.zeros_like(pos_dist)
        return out

    # helpers of the classes below
    def _bounds(self, num_objects_used: int, device):
        """The placement area's (lo, hi) in the goal's dtype, and the
        table's height as a scalar tensor."""
        lo, hi = self.idx.placement_bounds(num_objects_used, self.used_table_portion)
        _, _, table_h = self.idx.table_dimensions()
        f = lambda x: torch.as_tensor(x, dtype=self.dtype, device=device)  # noqa: E731
        return f(lo), f(hi), f(table_h)

    def _on_table(self, xy: torch.Tensor, object_size: torch.Tensor, table_h: torch.Tensor,
                  active_mask: torch.Tensor) -> torch.Tensor:
        """(B, O, 3) positions at `xy` (B, O, 2) resting on the table, the
        inactive slots parked."""
        z = table_h + object_size[..., 2].to(self.dtype)
        pos = torch.cat([xy, z.expand(xy.shape[:2])[..., None]], dim=-1)
        park = torch.as_tensor(sim_lib.PARK_POSITION, dtype=self.dtype, device=xy.device)
        return torch.where(active_mask[:, None], pos, park)


def _batch(x: torch.Tensor) -> torch.Tensor:
    return x[:, None, None]


class TrainStateGoal(ObjectStateGoal):
    """The training goals (goals/train_state.py): each target moves only
    `goal_distance_ratio` of the way from the object's position; with
    probability `pickup_proba` one object is lifted into the air, with
    `stacking_proba` a tower of a random size is built over a random
    object in a random order. Draws: the free placement's, `p_u` (B,) the
    branch, `lift_u` (B,) the height, `target_i` (B,) the lifted object,
    `tower_size` (B,) in [2, max(n, 2)] and `order` (B, O) the tower's."""

    def __init__(self, idx, args: GoalArgs = GoalArgs(), used_table_portion: float = 1.0,
                 dtype=torch.float32, goal_distance_ratio: float = 1.0):
        super().__init__(idx, args, used_table_portion, dtype)
        self.goal_distance_ratio = goal_distance_ratio

    def draw(self, gen, B, num_objects_used, device=None):
        out = super().draw(gen, B, num_objects_used, device)
        out.update(p_u=self._u(gen, device, B), lift_u=self._u(gen, device, B),
                   target_i=torch.randint(0, num_objects_used, (B,), generator=gen, device=device),
                   tower_size=torch.randint(2, max(num_objects_used, 2) + 1, (B,), generator=gen,
                                            device=device),
                   order=self._perm(gen, B, device))
        return out

    def next_goal(self, draws, active_mask, object_size, num_objects_used, d):
        goal = super().next_goal(draws, active_mask, object_size, num_objects_used, d)
        B, O = goal["obj_pos"].shape[:2]
        dev = goal["obj_pos"].device
        cur = sim_lib.object_positions(self.idx, d)
        ratio = torch.tensor(self.goal_distance_ratio, dtype=self.dtype, device=dev)
        pos = cur + (goal["obj_pos"] - cur) * ratio
        pos = torch.where(active_mask[:, None], pos, goal["obj_pos"])
        args = self.args
        # pickup (train_state.py:44-55)
        height = uniform_apply(draws["lift_u"], args.height_range[0], args.height_range[1])
        lift = torch.arange(O, device=dev)[None] == draws["target_i"][:, None]
        lifted_z = pos[..., 2] + torch.where(lift, (height * ratio)[:, None],
                                             torch.zeros_like(pos[..., 2]))
        lifted = torch.cat([pos[..., :2], lifted_z[..., None]], dim=-1)
        # stacking (train_state.py:57-77)
        order = draws["order"]
        base = self._take(pos, order[:, :1])[:, 0]                          # (B, 3)
        rank = torch.argsort(order, dim=-1)
        in_tower = (rank < draws["tower_size"][:, None]) & active_mask
        stacked_z = base[:, 2:3] + rank.to(self.dtype) * 2.0 * object_size[..., 2].to(self.dtype)
        tower = torch.cat([base[:, None, :2].expand(B, O, 2), stacked_z[..., None]], dim=-1)
        stacked = torch.where(in_tower[..., None], tower, pos)
        p = draws["p_u"]
        pos = torch.where(_batch(p < args.pickup_proba), lifted,
                          torch.where(_batch(p < args.pickup_proba + args.stacking_proba), stacked,
                                      pos))
        return dict(goal, obj_pos=pos)


class ObjectReachGoal(ObjectStateGoal):
    """Reach the first object's goal position with the gripper
    (goals/object_reach_goal.py:11-40): the distance is the TCP's, at slot
    0; `arm_idx` is the arm's index."""

    def __init__(self, idx, arm_idx: arm_lib.ArmIndex, args: GoalArgs = GoalArgs(),
                 used_table_portion: float = 1.0, dtype=torch.float32):
        super().__init__(idx, args, used_table_portion, dtype)
        self.arm_idx = arm_idx

    def goal_distance(self, goal, d, active_mask):
        dist = rot.norm(goal["obj_pos"][:, 0] - arm_lib.tcp_xyz(self.arm_idx, d))
        out = torch.zeros(dist.shape + (self.idx.max_num_objects,), dtype=dist.dtype,
                          device=dist.device)
        out[:, 0] = dist
        return {"obj_pos": out, "obj_rot": torch.zeros_like(out)}


class DeterministicReachGoal(ObjectReachGoal):
    """Reach goals from a fixed pool of two target positions
    (goals/object_reach_goal.py:56-81), the pool's index `pool_i` (B,)
    drawn."""

    ALL_POSITIONS = np.array([[1.50253879, 0.36960144, 0.5170952],
                              [1.32253879, 0.53960144, 0.5170952]])

    def draw(self, gen, B, num_objects_used, device=None):
        out = super().draw(gen, B, num_objects_used, device)
        out["pool_i"] = torch.randint(0, len(self.ALL_POSITIONS), (B,), generator=gen,
                                      device=device)
        return out

    def next_goal(self, draws, active_mask, object_size, num_objects_used, d):
        goal = super().next_goal(draws, active_mask, object_size, num_objects_used, d)
        pool = torch.as_tensor(self.ALL_POSITIONS, dtype=self.dtype, device=goal["obj_pos"].device)
        pos = goal["obj_pos"].clone()
        pos[:, 0] = pool[draws["pool_i"]]
        return dict(goal, obj_pos=pos)


class ObjectStackGoal(ObjectStateGoal):
    """A tower of the active objects over the first one's placement
    (goals/object_stack_goal.py:12-60), in slot order under `fixed_order`,
    else in a random order (`order` (B, O))."""

    def __init__(self, idx, args: GoalArgs = GoalArgs(), used_table_portion: float = 1.0,
                 dtype=torch.float32, fixed_order: bool = True):
        super().__init__(idx, args, used_table_portion, dtype)
        self.fixed_order = fixed_order

    def draw(self, gen, B, num_objects_used, device=None):
        out = super().draw(gen, B, num_objects_used, device)
        out["order"] = self._perm(gen, B, device)
        return out

    def next_goal(self, draws, active_mask, object_size, num_objects_used, d):
        goal = super().next_goal(draws, active_mask, object_size, num_objects_used, d)
        B, O = goal["obj_pos"].shape[:2]
        dev = goal["obj_pos"].device
        base = goal["obj_pos"][:, 0]
        rank = (torch.arange(O, device=dev).expand(B, O) if self.fixed_order
                else torch.argsort(draws["order"], dim=-1))
        heights = 2.0 * object_size[..., 2].to(self.dtype)
        stacked_z = base[:, 2:3] + rank.to(self.dtype) * heights
        tower = torch.cat([base[:, None, :2].expand(B, O, 2), stacked_z[..., None]], dim=-1)
        return dict(goal, obj_pos=torch.where(active_mask[:, None], tower, goal["obj_pos"]))


class PickAndPlaceGoal(ObjectStateGoal):
    """The first object lifted into the air, the others on the table
    (goals/pickandplace.py:10-30); `lift_u` (B,) the height in
    `height_range`."""

    def __init__(self, idx, args: GoalArgs = GoalArgs(), used_table_portion: float = 1.0,
                 dtype=torch.float32, height_range=(0.05, 0.25)):
        super().__init__(idx, args, used_table_portion, dtype)
        self.height_range = height_range

    def draw(self, gen, B, num_objects_used, device=None):
        out = super().draw(gen, B, num_objects_used, device)
        out["lift_u"] = self._u(gen, device, B)
        return out

    def next_goal(self, draws, active_mask, object_size, num_objects_used, d):
        goal = super().next_goal(draws, active_mask, object_size, num_objects_used, d)
        lift = uniform_apply(draws["lift_u"], self.height_range[0], self.height_range[1])
        pos = goal["obj_pos"].clone()
        pos[:, 0, 2] = pos[:, 0, 2] + lift
        return dict(goal, obj_pos=pos)


class ObjectFixedStateGoal(ObjectStateGoal):
    """Goals at fixed placements (goals/object_state_fixed.py): each
    object's (x, y) a fraction `relative_placements` (O, 2) of the
    placement area, on the table, at its fixed rotation `init_quats`
    (O, 4). No draws."""

    def __init__(self, idx, args: Optional[GoalArgs] = None, used_table_portion: float = 1.0,
                 dtype=torch.float32, relative_placements=None, init_quats=None):
        super().__init__(idx, args or GoalArgs(), used_table_portion, dtype)
        O = idx.max_num_objects
        if relative_placements is None:
            relative_placements = np.tile(np.asarray([[0.5, 0.5]]), (O, 1))
        if init_quats is None:
            init_quats = np.tile(np.asarray([[1.0, 0.0, 0.0, 0.0]]), (O, 1))
        self.relative_placements = np.asarray(relative_placements)
        self.init_quats = np.asarray(init_quats)

    def draw(self, gen, B, num_objects_used, device=None):
        return {}

    def next_goal(self, draws, active_mask, object_size, num_objects_used, d):
        dev = active_mask.device
        lo, hi, table_h = self._bounds(num_objects_used, dev)
        frac = torch.as_tensor(self.relative_placements, dtype=self.dtype, device=dev)
        xy = (lo[:2] + frac * (hi[:2] - lo[:2])).expand((d.qpos.shape[0],) + frac.shape)
        pos = self._on_table(xy, object_size, table_h, active_mask)
        quat = torch.as_tensor(self.init_quats, dtype=self.dtype, device=dev)
        B = pos.shape[0]
        return {"obj_pos": pos, "obj_rot": quat.expand((B,) + quat.shape).clone(),
                "goal_valid": torch.ones(B, dtype=torch.bool, device=dev)}


class DominoStateGoal(ObjectStateGoal):
    """Dominos standing along a circular arc, each facing along it
    (goals/dominos.py): the arc's start angle `ang_u` (B,) in [0, 2 pi)
    and a jitter of its centre `off_u` (B, 2) in [-0.02, 0.02) m, its
    radius 0.35 of the placement area's shorter side."""

    def draw(self, gen, B, num_objects_used, device=None):
        return {"ang_u": self._u(gen, device, B), "off_u": self._u(gen, device, B, 2)}

    def next_goal(self, draws, active_mask, object_size, num_objects_used, d):
        dev = active_mask.device
        O = self.idx.max_num_objects
        lo, hi, table_h = self._bounds(num_objects_used, dev)
        center = (lo[:2] + hi[:2]) / 2.0
        radius = torch.minimum(hi[0] - lo[0], hi[1] - lo[1]) * 0.35
        base = uniform_apply(draws["ang_u"], 0.0, 2 * np.pi)
        spacing = 2.5 * object_size[..., 0].to(self.dtype).amax(-1)
        thetas = base[:, None] + torch.arange(O, dtype=self.dtype, device=dev) * (
            spacing / radius)[..., None]
        xy = center + radius * torch.stack([torch.cos(thetas), torch.sin(thetas)], dim=-1)
        xy = xy + uniform_apply(draws["off_u"], -0.02, 0.02)[:, None, :]
        pos = self._on_table(xy, object_size, table_h, active_mask)
        z = torch.tensor([0.0, 0.0, 1.0], dtype=self.dtype, device=dev)
        quat = rot.quat_from_angle_and_axis(thetas + np.pi / 2, z).to(self.dtype)
        return {"obj_pos": pos, "obj_rot": quat,
                "goal_valid": torch.ones(pos.shape[0], dtype=torch.bool, device=dev)}
