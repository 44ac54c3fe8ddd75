"""The env core, batched: tracker state, env state, rewards and the
divergence guard.

Counterpart of `robogym_tpu/envs/core.py`. Where the JAX package writes
each function for one env and vmaps it, every tensor here carries a
leading env axis `(B, ...)`, and the functions work on the whole batch.
`EnvState` has no PRNG key: an env draws from a `torch.Generator` it
holds. The reward triple [env_reward, goal_distance_reward - penalty,
success_reward] and the multi-goal bookkeeping are the JAX package's
(MultiGoalTracker.process): consecutive success counting with a sampled
hold duration, per-goal timeout -> done, goal resample on success within
the episode, trial success after `successes_needed` goals.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from robogym_torch.mjcf.model import Contact, Data, Model


@dataclasses.dataclass(frozen=True)
class TrackerState:
    """MultiGoalTracker state, each field `(B,)` (the by-type counts
    `(B, n_goal_types)`)."""

    steps: torch.Tensor                      # int32, env steps this episode
    steps_since_last_goal: torch.Tensor      # int32
    consecutive_successes: torch.Tensor      # int32
    successes_so_far: torch.Tensor           # int32
    success_steps_required: torch.Tensor     # int32, the sampled hold duration
    success_and_no_goal_reset: torch.Tensor  # bool
    trial_success: torch.Tensor              # bool
    goals_so_far: torch.Tensor               # int32, 1 after reset (the first goal)
    sub_goal_success: torch.Tensor           # bool, success fired this step
    steps_by_type: torch.Tensor              # int32 (B, n_goal_types)
    successes_by_type: torch.Tensor          # int32 (B, n_goal_types)

    def replace(self, **kw) -> "TrackerState":
        return dataclasses.replace(self, **kw)

    @classmethod
    def zero(cls, batch: int, n_goal_types: int = 1, device=None) -> "TrackerState":
        def z(dtype=torch.int32, *shape):
            return torch.zeros((batch,) + shape, dtype=dtype, device=device)

        return cls(
            steps=z(), steps_since_last_goal=z(), consecutive_successes=z(),
            successes_so_far=z(), success_steps_required=z() + 1,
            success_and_no_goal_reset=z(torch.bool), trial_success=z(torch.bool),
            goals_so_far=z() + 1, sub_goal_success=z(torch.bool),
            steps_by_type=z(torch.int32, n_goal_types),
            successes_by_type=z(torch.int32, n_goal_types),
        )


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Per-env state, every tensor `(B, ...)`: physics, goal, tracker and
    the env step count. `model_fields` carries per-episode model fields,
    each `(B, ...)` (`apply_model_fields`); the locked env sets none, a
    wrapper stack sets those its transforms randomize, the rearrange env the
    objects' colours. `goal_aux` is the goal generator's carry (the
    rearrange env's: its solver sim's Data)."""

    physics: Data
    goal: Any                    # goal dict (env-specific)
    goal_aux: Any                # goal generator carry
    prev_goal_distance: Any      # dict of (B, ...) distances
    tracker: TrackerState
    t: torch.Tensor              # int32 (B,)
    model_fields: Any = None     # dict: Model field name -> overridden tensor
    robot_aux: Any = None        # per-episode robot controller state (a gripper's
                                 # RegraspState), or None

    def replace(self, **kw) -> "EnvState":
        return dataclasses.replace(self, **kw)


def apply_model_fields(model: Model, fields) -> Model:
    """Overlay per-episode fields onto the static Model. Keys are Model
    field names; `"opt:<name>"` addresses Option fields. Each value is the
    field with a leading env axis `(B, ...)`, and the overlaid model names
    it in `env_fields`; a field not given stays shared. The diagApprox
    weights (`setconst.invweight0`) stay those of the compiled model, as
    the JAX package computes them once at compile time."""
    if not fields:
        return model
    from robogym_torch.physics.setconst import invweight0

    invweight0(model)
    plain = {k: v for k, v in fields.items() if not k.startswith("opt:")}
    opt = {k[4:]: v for k, v in fields.items() if k.startswith("opt:")}
    if plain:
        model = model.replace(**plain)
    if opt:
        model = model.replace(opt=dataclasses.replace(model.opt, **opt))
    return model.replace(env_fields=model.env_fields | frozenset(fields))


def take_model_envs(model: Model, envs: torch.Tensor) -> Model:
    """The model of the envs `envs` (k,) of the batch: each per-env field
    (`env_fields`) cut to those envs' rows."""
    plain = {k: getattr(model, k)[envs] for k in model.env_fields if not k.startswith("opt:")}
    opt = {k[4:]: getattr(model.opt, k[4:])[envs] for k in model.env_fields
           if k.startswith("opt:")}
    model = model.replace(**plain)
    return model.replace(opt=dataclasses.replace(model.opt, **opt)) if opt else model


@dataclasses.dataclass(frozen=True)
class EnvConstants:
    """Static env configuration: the fields of the JAX package's
    `EnvConstants` that the locked env reads."""

    mujoco_substeps: int = 10
    mujoco_timestep: float = 0.002
    success_reward: float = 5.0
    successes_needed: int = 5
    max_timesteps_per_goal: Optional[int] = None
    success_pause_range_s: Tuple[float, float] = (0.0, 0.0)
    relative_action: bool = True
    max_position_change: Optional[float] = None

    @property
    def step_duration(self) -> float:
        return self.mujoco_substeps * self.mujoco_timestep


def uniform_apply(u: torch.Tensor, lo, hi) -> torch.Tensor:
    """Uniform draws u in [0, 1) mapped to [lo, hi), in u's dtype, as
    `jax.random.uniform` maps its own (lo + u * (hi - lo), at least lo)."""
    lo = torch.as_tensor(lo, dtype=u.dtype, device=u.device)
    hi = torch.as_tensor(hi, dtype=u.dtype, device=u.device)
    return torch.maximum(lo, u * (hi - lo) + lo)


def sample_success_steps_required(u: torch.Tensor, constants: EnvConstants) -> torch.Tensor:
    """Sampled success-hold steps from uniform draws u (B,) in [0, 1)
    (multi_goal_tracker.py:84-94)."""
    lo_s, hi_s = constants.success_pause_range_s
    dt = constants.step_duration
    lo, hi = max(1.0, lo_s / dt), max(1.0, hi_s / dt)
    return torch.round(uniform_apply(u.float(), lo, hi)).to(torch.int32)


def tracker_process(tracker: TrackerState, constants: EnvConstants, is_successful: torch.Tensor,
                    solved: torch.Tensor, goal_type: Optional[torch.Tensor] = None):
    """One step of MultiGoalTracker.process for the batch. `goal_type` (B,)
    is each env's current goal type (None: one "generic" type). Returns
    (tracker', success_reward, done, need_new_goal), each `(B,)`."""
    n_types = tracker.steps_by_type.shape[-1]
    dev = tracker.steps.device
    gt = torch.zeros_like(tracker.steps) if goal_type is None else goal_type.to(torch.int32)
    type_onehot = (torch.arange(n_types, device=dev) == gt[:, None]).to(torch.int32)

    steps = tracker.steps + 1
    ssg = tracker.steps_since_last_goal + 1
    consec = torch.where(is_successful, tracker.consecutive_successes + 1,
                         torch.zeros_like(tracker.consecutive_successes))
    goal_hold_reached = (consec >= tracker.success_steps_required) & \
        ~tracker.success_and_no_goal_reset
    success_reward = torch.where(goal_hold_reached, constants.success_reward, 0.0)
    successes = tracker.successes_so_far + goal_hold_reached.to(torch.int32)

    if constants.max_timesteps_per_goal is not None:
        timeout = ssg >= constants.max_timesteps_per_goal
    else:
        timeout = torch.zeros_like(goal_hold_reached)
    done = timeout & ~goal_hold_reached

    pending = tracker.success_and_no_goal_reset | goal_hold_reached
    fire = pending  # min_timesteps_per_goal is 0: the goal resamples the same step
    trial_success = fire & ((successes >= constants.successes_needed) | solved)
    done = done | trial_success
    need_new_goal = fire & ~trial_success
    zero = torch.zeros_like(ssg)
    tracker = TrackerState(
        steps=steps,
        steps_since_last_goal=torch.where(need_new_goal | trial_success, zero, ssg),
        consecutive_successes=torch.where(need_new_goal, zero, consec),
        successes_so_far=successes,
        success_steps_required=tracker.success_steps_required,
        success_and_no_goal_reset=pending & ~fire,
        trial_success=trial_success,
        goals_so_far=tracker.goals_so_far + need_new_goal.to(torch.int32),
        sub_goal_success=goal_hold_reached,
        steps_by_type=tracker.steps_by_type + type_onehot,
        successes_by_type=tracker.successes_by_type
        + type_onehot * goal_hold_reached.to(torch.int32)[:, None],
    )
    return tracker, success_reward, done, need_new_goal


def tracker_info(tracker: TrackerState, constants: EnvConstants,
                 goal_type_names: Tuple[str, ...] = ("generic",),
                 goal_type: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """The tracker's info keys (multi_goal_tracker.py:243-277), each (B,):
    steps_per_success = (steps - steps on the unfinished goal) /
    successes, max_timesteps_per_goal before the first success."""
    default = float(constants.max_timesteps_per_goal
                    if constants.max_timesteps_per_goal is not None else 0)
    succ = tracker.successes_so_far
    sps = torch.where(succ > 0, (tracker.steps - tracker.steps_since_last_goal)
                      / torch.clamp(succ, min=1).to(torch.float32), default)
    n_types = tracker.steps_by_type.shape[-1]
    gt = torch.zeros_like(succ) if goal_type is None else goal_type.to(torch.int32)
    cur = (torch.arange(n_types, device=succ.device) == gt[:, None]).to(torch.int32)
    unsucc_t = cur * tracker.steps_since_last_goal[:, None]
    sps_t = torch.where(tracker.successes_by_type > 0,
                        (tracker.steps_by_type - unsucc_t)
                        / torch.clamp(tracker.successes_by_type, min=1).to(torch.float32),
                        default)
    info: Dict[str, torch.Tensor] = {
        "goals_so_far": tracker.goals_so_far,
        "successes_so_far": tracker.successes_so_far,
        "steps_since_last_goal": tracker.steps_since_last_goal,
        "consecutive_steps_with_success": tracker.consecutive_successes,
        "sub_goal_is_successful": tracker.sub_goal_success,
        "trial_success": tracker.trial_success,
        "steps_per_success": sps,
    }
    for i, name in enumerate(goal_type_names):
        info[f"steps_by_goal_type/{name}"] = tracker.steps_by_type[:, i]
        info[f"successes_so_far_by_goal_type/{name}"] = tracker.successes_by_type[:, i]
        info[f"steps_per_success_by_goal_type/{name}"] = sps_t[:, i]
    return info


def data_map(fn, *ds: Data) -> Data:
    """`fn` over the matching tensors of states `ds` (the contact set's
    too), like a tree map."""
    def fields(obj):
        return [f.name for f in dataclasses.fields(obj)]

    kw = {}
    for name in fields(Data):
        if name == "contact":
            cs = [d.contact for d in ds]
            kw[name] = Contact(**{c: fn(*[getattr(x, c) for x in cs]) for c in fields(Contact)})
        else:
            kw[name] = fn(*[getattr(d, name) for d in ds])
    return Data(**kw)


def data_where(mask: torch.Tensor, a: Data, b: Data) -> Data:
    """Per env, state `a` where `mask` (B,) holds, else `b`, over every
    field."""
    return data_map(lambda x, y: torch.where(mask.view((-1,) + (1,) * (x.dim() - 1)), x, y), a, b)


def tree_map(fn, tree):
    """`fn` over the tensors of a tree of dicts, tuples, lists, states and
    tensors; any other leaf stays as it is."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, Data):
        return data_map(fn, tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{f.name: tree_map(fn, getattr(tree, f.name))
                                            for f in dataclasses.fields(tree)})
    return tree


def take_envs(state: EnvState, envs: torch.Tensor) -> EnvState:
    """The env state of the envs `envs` (k,) of the batch."""
    return tree_map(lambda x: x[envs], state)


def divergence_guard(d_prev: Data, d: Data, qvel_limit: float = 1e6) -> Tuple[Data, torch.Tensor]:
    """Non-finite or exploding state after the physics step -> crashed. A
    crashed env keeps its pre-step physics, over every field, contact set
    included (so observations stay finite for the rest of the batch), and
    reports crashed (B,) = True; the caller sets done and
    `info["env_crash"]`."""
    fastest = (torch.abs(d.qvel).amax(-1) if d.qvel.shape[-1]
               else torch.zeros_like(d.time))
    bad = ~(torch.isfinite(d.qpos).all(-1) & torch.isfinite(d.qvel).all(-1)
            & (fastest < qvel_limit))
    return data_where(bad, d_prev, d), bad


def goal_distance_sum(dist: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Each env's sum over the distance keys (robot_env.py:550-559)."""
    total = 0.0
    for k in sorted(dist.keys()):
        v = dist[k]
        total = total + (v.reshape(v.shape[0], -1).sum(-1) if v.dim() > 1 else v)
    return total


def is_successful(dist: Dict[str, torch.Tensor], thresholds: Dict[str, float]) -> torch.Tensor:
    """Per env, every goal distance below its threshold (robot_env.py:569-575)."""
    ok = None
    for k, thr in thresholds.items():
        v = dist[k] < thr
        v = v.reshape(v.shape[0], -1).all(-1) if v.dim() > 1 else v
        ok = v if ok is None else ok & v
    return ok
