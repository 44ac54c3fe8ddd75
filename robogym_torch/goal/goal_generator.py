"""The goal-generator protocol.

Counterpart of `robogym_tpu/goal/goal_generator.py` (reference
goal_generator.py:7-68). A goal generator makes goals and measures
distances as functions of batched tensors, `(B, ...)`; its draws come from
a `torch.Generator` or from the caller. The generators are the envs' own:
`envs.dactyl.locked` (LockedParallelGoal), `envs.dactyl.reach`
(FingertipPosGoal), `envs.dactyl.face_perpendicular` and
`full_perpendicular`, and `envs.rearrange.goals`.
"""

from __future__ import annotations

from typing import Any, Dict, Protocol, Set


class GoalGenerator(Protocol):
    """next_goal(draws, ...) -> goal dict, each value (B, ...)
    (reference next_goal); goal_distance(goal, data, ...) -> dict of
    (B, ...) distances (reference goal_distance). The reference's
    `current_state` and `relative_goal` are observation conveniences; the
    wrapper layer's relative-goal transform gives those observations."""

    def next_goal(self, draws: Dict[str, Any], *args, **kwargs) -> Dict[str, Any]:
        ...

    def goal_distance(self, goal: Dict[str, Any], *args, **kwargs) -> Dict[str, Any]:
        ...


def goal_types() -> Set[str]:
    return {"generic"}
