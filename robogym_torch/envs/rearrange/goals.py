"""Rearrange goal generation, batched: free placements of every object
(`ObjectStateGoal`, the blocks env's default "state" goals), rotational
distances and the greedy matching of duplicate objects to goals.

Counterpart of the part of `robogym_tpu/envs/rearrange/goals.py` that
`ObjectStateGoal` runs. Every random function takes its uniform draws from
the caller: `sample_goal_positions` its `(B, O, 20, 2)` candidates,
`sample_goal_rotations` one draw per object for "z_axis" or three for
"full". The other goal classes (train, reach, stack, pick-and-place) are
not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from robogym_torch.envs.core import uniform_apply
from robogym_torch.envs.rearrange import simulation as sim_lib
from robogym_torch.mjcf.model import Data
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
                          dtype=torch.float32, device=None) -> torch.Tensor:
    """(B, O, 4) object rotations: identity unless `args.randomize_goal_rot`,
    else about z from u (B, O) ("z_axis") or uniform from u (B, O, 3)
    ("full"), each computed in u's dtype and cast to `dtype`."""
    if not args.randomize_goal_rot:
        q = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)
        return q.expand(B, O, 4).clone()
    if args.rot_randomize_type == "z_axis":
        return rot.uniform_z_quat_apply(u).to(dtype)
    if args.rot_randomize_type == "full":
        return rot.uniform_quat_apply(u).to(dtype)
    raise NotImplementedError(f"rot_randomize_type {args.rot_randomize_type!r} is not ported")


def _symmetry_quats(dist_type: str, like: torch.Tensor) -> torch.Tensor:
    sym = rot.get_parallel_rotations_180() if dist_type == "mod180" else \
        rot.get_parallel_rotations()
    return torch.as_tensor(sym, dtype=like.dtype, device=like.device)


def rot_distance(q1: torch.Tensor, q2: torch.Tensor, dist_type: str = "full") -> torch.Tensor:
    """(..., O) rotational distance of quats (..., O, 4): the full quat
    distance, or its minimum over the box's symmetries ("mod90": the 24
    cube rotations, "mod180": the 4 made of multiples of pi)."""
    if dist_type == "full":
        return rot.quat_magnitude(rot.quat_normalize(rot.quat_difference(q1, q2)))
    if dist_type not in ("mod90", "mod180"):
        raise NotImplementedError(f"rot_dist_type {dist_type!r} is not ported")
    sym = _symmetry_quats(dist_type, q1)
    cands = rot.quat_magnitude(rot.quat_normalize(rot.quat_difference(
        rot.quat_mul(q1[..., None, :], sym), q2[..., None, :])))
    return cands.amin(-1)


def relative_rot_euler(q_goal: torch.Tensor, q_cur: torch.Tensor,
                       dist_type: str = "full") -> torch.Tensor:
    """(..., O, 3) each object's rotation to its goal as euler angles, after
    the symmetry reduction of `dist_type` (goals/object_state.py:196-201)."""
    if dist_type == "full":
        return rot.quat2euler(rot.quat_normalize(rot.quat_difference(q_goal, q_cur)))
    if dist_type not in ("mod90", "mod180"):
        raise NotImplementedError(f"rot_dist_type {dist_type!r} is not ported")
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
        if args.rot_dist_type == "icp":
            raise NotImplementedError("the icp rotational distance needs utils/icp.py, which "
                                      "the port does not have")
        self.idx = idx
        self.args = args
        self.used_table_portion = used_table_portion
        self.dtype = dtype

    def next_goal(self, pos_u: torch.Tensor, rot_u: Optional[torch.Tensor],
                  active_mask: torch.Tensor, object_size: torch.Tensor,
                  num_objects_used: int) -> Dict[str, torch.Tensor]:
        """A goal for each env from its candidates' draws pos_u (B, O, C, 2)
        and rotation draws rot_u (see `sample_goal_rotations`)."""
        pos, valid = sample_goal_positions(pos_u, self.idx, active_mask, object_size,
                                           num_objects_used, self.used_table_portion)
        quat = sample_goal_rotations(rot_u, pos.shape[0], self.idx.max_num_objects, self.args,
                                     self.dtype, pos.device)
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
                                 self.args.rot_dist_type)
            out["obj_rot"] = rdist * mask
        else:
            out["obj_rot"] = torch.zeros_like(pos_dist)
        return out


def draw_goal(gen: torch.Generator, B: int, O: int, args: GoalArgs, dtype=torch.float32,
              device=None) -> Dict[str, torch.Tensor]:
    """The draws of one `ObjectStateGoal.next_goal` for B envs: candidates
    (B, O, C, 2) and, where goals randomize rotations, their draws."""
    out = {"pos_u": torch.rand((B, O, N_CANDIDATES, 2), generator=gen, dtype=dtype,
                               device=device), "rot_u": None}
    if args.randomize_goal_rot:
        shape = (B, O) if args.rot_randomize_type == "z_axis" else (B, O, 3)
        out["rot_u"] = torch.rand(shape, generator=gen, dtype=dtype, device=device)
    return out

