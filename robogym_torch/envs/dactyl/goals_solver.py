"""Solver-driven Rubik's goals, batched: after a reset's scramble the host
solves each env's cube with the two-phase solver (`utils/rubik_utils`),
and the goals then walk that solution one face turn at a time, each a
turn of the planned face with that face up.

Counterpart of `robogym_tpu/envs/dactyl/goals_solver.py` (reference
goals/rubik_cube_solver.py, unconstrained_cube_solver.py,
face_cube_solver.py). The solve is host work once a reset
(`solve_and_attach`, one solve an env, as the reference calls kociemba);
the plan (B, MAX_SOLUTION_LEN, 3) of [axis, side, angle] rows, its length
and the step reached ride in the env state's `goal_aux`, and advancing a
goal is device work.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from robogym_torch.envs.dactyl import cube_manipulator as manip
from robogym_torch.utils import rotation as rot
from robogym_torch.utils import rubik_utils

MAX_SOLUTION_LEN = 26  # the two-phase bound (at most 24 moves) and slack


def _solve_host(mats: np.ndarray, coords: np.ndarray) -> Tuple[np.ndarray, np.int32]:
    """Cubelet rotation matrices (20, 3, 3) -> (plan (MAX_SOLUTION_LEN, 3)
    float32 [axis, side, angle], length): length 0 where the state is not
    a legal cube or the search fails."""
    plan = np.zeros((MAX_SOLUTION_LEN, 3), np.float32)
    try:
        sol = rubik_utils.solve_fast(rubik_utils.cubelets_to_facelets(coords, mats))
    except KeyError:   # a matrix that is not a signed permutation
        sol = None
    if sol is None:
        return plan, np.int32(0)
    steps = rubik_utils.moves_to_face_rotations(sol)[:MAX_SOLUTION_LEN]
    for i, s in enumerate(steps):
        plan[i] = s
    return plan, np.int32(len(steps))


def empty_plan(batch: int, dtype=torch.float32, device=None):
    """(plan (B, MAX_SOLUTION_LEN, 3) zeros, length (B,) int32 zeros)."""
    return (torch.zeros((batch, MAX_SOLUTION_LEN, 3), dtype=dtype, device=device),
            torch.zeros((batch,), dtype=torch.int32, device=device))


def snapped_matrices(idx: manip.CubeletIndex, qpos: torch.Tensor) -> np.ndarray:
    """(B, 20, 3, 3) each env's cubelet matrices after `soft_align_faces`,
    rounded to signed permutations, on the host."""
    aligned = manip.soft_align_faces(idx, qpos)
    return np.round(rot.euler2mat(manip.cubelet_eulers(idx, aligned)).cpu().numpy())


def legal_cubes(idx: manip.CubeletIndex, qpos: torch.Tensor) -> np.ndarray:
    """(B,) bool: whether each env's `snapped_matrices` give a legal
    facelet string (`rubik_utils.is_legal`), a cube the solver can take."""
    out = []
    for mats in snapped_matrices(idx, qpos):
        try:
            out.append(rubik_utils.is_legal(rubik_utils.cubelets_to_facelets(idx.coords, mats)))
        except KeyError:   # a matrix that is not a signed permutation
            out.append(False)
    return np.asarray(out, bool)


def solve_plan_host(idx: manip.CubeletIndex, qpos) -> Tuple[np.ndarray, np.int32]:
    """One env's solve from its qpos (nq,): the faces soft-aligned first
    (mid-episode cubelets can be far from straight, as the reference's
    to_pycuber does), the matrices snapped, then `_solve_host`."""
    q = torch.as_tensor(np.asarray(qpos))[None]
    return _solve_host(snapped_matrices(idx, q)[0], idx.coords)


def solve_and_attach(env, state):
    """The batched solver-mode `state` with each env's solution plan in
    `goal_aux` (the step at 0), and its goal and goal distance refreshed.
    Host-side: one solve an env."""
    mats = snapped_matrices(env.cubelets, state.physics.qpos)
    solved = [_solve_host(m, env.cubelets.coords) for m in mats]
    dev = state.physics.qpos.device
    plan = torch.as_tensor(np.stack([p for p, _ in solved]), dtype=env.dtype, device=dev)
    length = torch.as_tensor(np.stack([n for _, n in solved]), device=dev)
    aux = (plan, length, torch.zeros_like(length))
    goal = env._solver_goal(state.physics, aux)
    return state.replace(goal_aux=aux, goal=goal,
                         prev_goal_distance=env._goal_distance(goal, state.physics))


def plan_entry(plan: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """(B, 3) each env's plan row at its step, clipped into the plan."""
    i = torch.clamp(step.long(), 0, plan.shape[1] - 1)
    return plan[torch.arange(plan.shape[0], device=plan.device), i]


def goal_face_angles_after(idx: manip.CubeletIndex, qpos: torch.Tensor, plan: torch.Tensor,
                           step: torch.Tensor) -> torch.Tensor:
    """(B, 6) the face-angle goal of each env's solution step: its face
    angles rounded to straight, with the planned turn added to the planned
    face."""
    angles = rot.round_to_straight_angles(manip.driver_angles(idx, qpos))
    entry = plan_entry(plan, step)
    didx = entry[:, 0].long() * 2 + entry[:, 1].long()
    hit = torch.arange(6, device=qpos.device) == didx[:, None]
    return rot.normalize_angles(torch.where(hit, angles + entry[:, 2:3].to(angles.dtype), angles))
