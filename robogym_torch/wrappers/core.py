"""The wrapper layer, batched: composable transforms around a batched env.

Counterpart of `robogym_tpu/wrappers/core.py`. A wrapper is a `Transform`:
a host object holding static configuration, with functions over an
explicit per-episode state whose every tensor has a leading env axis
`(B, ...)`. `WrappedEnv` composes a transform list around an env with the
port's batched API (`reset(batch)`, `step(state, action)`), in the JAX
package's order:

  action path (outermost transform first, like gym nesting):
      for t in reversed(transforms): action = t.action(...)
  per-step model fields, then per-step physics, then the env's step;
  reward, observation and done (innermost first, each transform's three
  in that order):
      for t in transforms: reward = t.reward(...); obs = ...; done = ...

Per-episode model randomization (`Transform.model`) runs at reset on a dict
of the overridden fields, each `(B, ...)`, stored in
`EnvState.model_fields` and laid over the env's model by its step
(`envs.core.apply_model_fields`). The transform states ride in
`EnvState.goal_aux = (inner_goal_aux, tuple of transform states)`.

Randomness: every hook that draws has a `draw_<hook>` that makes its
samples for the batch from the env's `torch.Generator` (uniform [0, 1),
standard normal, exponential, integers), and the hook applies them. A
caller may pass the draws instead (`draws=`): a dict from hook name
("init", "model", "action", "model_step", "physics", "observation") to one
entry per transform, or to a function of the transform's index and the
hook's `draw_<hook>` arguments after `env` (an observation's draws depend
on the transform state and the observation that reach it), and "env" for
the inner env's draws.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import torch

from robogym_torch.envs import core


class Transform:
    """Base transform: identity everywhere. Subclasses override what they
    need; a `draw_<hook>` returns None where the hook draws nothing."""

    #: Model field names this transform randomizes per episode
    #: (Model attribute names; "opt:<name>" for Option fields).
    model_fields: Sequence[str] = ()
    #: set True if the transform implements `physics`
    has_physics_hook: bool = False

    def draw_init(self, gen: torch.Generator, batch: int, env) -> Optional[Dict]:
        return None

    def init(self, draws, env, batch: int) -> Any:
        """Per-episode transform state for `batch` envs."""
        return torch.zeros(batch, dtype=torch.int32, device=env.device)

    def draw_model(self, gen: torch.Generator, batch: int, env) -> Optional[Dict]:
        return None

    def model(self, tstate, fields: Dict[str, torch.Tensor], draws) -> Dict[str, torch.Tensor]:
        """Per-episode randomization of the overridden `fields` (each
        `(B, ...)`), at reset. Returns the new dict."""
        return fields

    def draw_action(self, gen: torch.Generator, batch: int, env) -> Optional[Dict]:
        return None

    def action(self, tstate, action: torch.Tensor, draws, env, env_state):
        """Inward action transform. Returns (tstate', action')."""
        return tstate, action

    def draw_physics(self, gen: torch.Generator, batch: int, env) -> Optional[Dict]:
        return None

    def physics(self, tstate, physics, draws, env):
        """Per-step physics-state change before the env's step. Returns
        (tstate', physics')."""
        return tstate, physics

    def draw_model_step(self, gen: torch.Generator, batch: int, env) -> Optional[Dict]:
        return None

    def model_step(self, tstate, model_fields, draws, env):
        """Per-step change of the model fields; called only where the
        transform names `model_fields`. Returns (tstate', model_fields')."""
        return tstate, model_fields

    def draw_observation(self, gen: torch.Generator, batch: int, env, tstate,
                         obs) -> Optional[Dict]:
        return None

    def observation(self, tstate, obs: Dict, draws, env, env_state):
        """Outward observation transform. Returns (tstate', obs')."""
        return tstate, obs

    def reward(self, tstate, reward: torch.Tensor):
        """Outward reward transform (reward (B, 3): env, goal, success).
        Returns (tstate', reward')."""
        return tstate, reward

    def done(self, tstate, done: torch.Tensor, env, env_state):
        return tstate, done


def model_field(model, name: str) -> torch.Tensor:
    """Field `name` of a Model ("opt:<name>" for an Option field)."""
    return getattr(model.opt, name[4:]) if name.startswith("opt:") else getattr(model, name)


class WrappedEnv:
    """A batched env and a transform stack, with the env's batched API."""

    def __init__(self, env, transforms: Sequence[Transform]):
        self.env = env
        self.transforms = list(transforms)
        self.dtype = env.dtype
        self.device = env.device
        self.constants = env.constants
        self.action_size = env.action_size
        self.generator = env.generator
        self._model_field_names: List[str] = []
        for t in self.transforms:
            for f in t.model_fields:
                if f not in self._model_field_names:
                    self._model_field_names.append(f)

    def _draws(self, draws, hook: str, i: int, batch: int, *args):
        """Transform i's draws for `hook`: the caller's, or its own."""
        if draws is not None and hook in draws:
            d = draws[hook]
            return d(i, *args) if callable(d) else d[i]
        return getattr(self.transforms[i], "draw_" + hook)(self.generator, batch, self.env, *args)

    def _randomize_model(self, tstates, draws, batch: int):
        """Run the model transforms on the env's fields, each expanded to
        `(B, ...)`; returns the dict of overridden fields (None if no
        transform overrides one)."""
        if not self._model_field_names:
            return None
        fields = {}
        for f in self._model_field_names:
            v = model_field(self.env.model, f)
            fields[f] = v.expand((batch,) + tuple(v.shape)).clone()
        for i, (t, ts) in enumerate(zip(self.transforms, tstates)):
            fields = t.model(ts, fields, self._draws(draws, "model", i, batch))
        return fields

    # -- env API ------------------------------------------------------------
    def reset(self, batch: int, draws: Optional[Dict] = None):
        """`batch` new episodes: (state, obs). `draws["env"]`, if given,
        holds the inner env's reset draws as keywords of its `reset`."""
        env_draws = (draws or {}).get("env") or {}
        state, obs = self.env.reset(batch, **env_draws)
        return self.wrap_reset(state, obs, draws)

    def wrap_reset(self, state: core.EnvState, obs: Dict, draws: Optional[Dict] = None):
        """The transforms' part of `reset` on the inner env's reset `state`
        and `obs`: transform states, model randomization and the
        observation path."""
        B = state.t.shape[0]
        tstates = [t.init(self._draws(draws, "init", i, B), self.env, B)
                   for i, t in enumerate(self.transforms)]
        fields = self._randomize_model(tstates, draws, B)
        if fields is not None:
            merged = dict(state.model_fields or {})
            merged.update(fields)
            state = state.replace(model_fields=merged)
        for i, t in enumerate(self.transforms):
            tstates[i], obs = t.observation(
                tstates[i], obs, self._draws(draws, "observation", i, B, tstates[i], obs),
                self.env, state)
        return state.replace(goal_aux=(state.goal_aux, tuple(tstates))), obs

    def step(self, state: core.EnvState, action: torch.Tensor, draws: Optional[Dict] = None):
        """One env step for the batch: (state, obs, reward, done, info).
        `draws["env"]`, if given, is the inner env's step draws."""
        inner_aux, tstates = state.goal_aux
        tstates = list(tstates)
        B = state.t.shape[0]
        n = range(len(self.transforms))

        for i in reversed(n):
            tstates[i], action = self.transforms[i].action(
                tstates[i], action, self._draws(draws, "action", i, B), self.env, state)

        model_fields = state.model_fields
        if self._model_field_names:
            for i, t in enumerate(self.transforms):
                if t.model_fields:
                    tstates[i], model_fields = t.model_step(
                        tstates[i], model_fields, self._draws(draws, "model_step", i, B),
                        self.env)

        physics = state.physics
        for i, t in enumerate(self.transforms):
            if t.has_physics_hook:
                tstates[i], physics = t.physics(tstates[i], physics,
                                                self._draws(draws, "physics", i, B), self.env)

        inner_state = state.replace(goal_aux=inner_aux, model_fields=model_fields,
                                    physics=physics)
        inner_state, obs, reward, done, info = self.env.step(
            inner_state, action, draws=(draws or {}).get("env"))

        for i in n:
            t = self.transforms[i]
            tstates[i], reward = t.reward(tstates[i], reward)
            tstates[i], obs = t.observation(
                tstates[i], obs, self._draws(draws, "observation", i, B, tstates[i], obs),
                self.env, inner_state)
            tstates[i], done = t.done(tstates[i], done, self.env, inner_state)

        out = inner_state.replace(goal_aux=(inner_state.goal_aux, tuple(tstates)))
        return out, obs, reward, done, info


def apply_named_wrappers(env, wrappers: Sequence) -> WrappedEnv:
    """Wrapper list application: each entry is [name or class, kwargs?];
    names resolve against the `robogym_torch.wrappers` registry."""
    from robogym_torch import wrappers as W

    transforms = []
    for entry in wrappers:
        name = entry[0]
        kwargs = entry[1] if len(entry) > 1 else {}
        cls = getattr(W, name) if isinstance(name, str) else name
        transforms.append(cls(env=env, **kwargs))
    return WrappedEnv(env, transforms)


def edit_wrappers(wrappers: List, insert_above=(), insert_below=(), replace=(),
                  delete=()) -> List:
    """List surgery by wrapper name (named_wrappers.py:27-76)."""
    wrappers = [list(w) for w in wrappers]

    def find(name: str) -> int:
        for i, w in enumerate(wrappers):
            wname = w[0] if isinstance(w[0], str) else w[0].__name__
            if wname == name:
                return i
        raise ValueError(f"Wrapper {name} not found")

    for name, new in insert_above:
        wrappers.insert(find(name), list(new))
    for name, new in insert_below:
        wrappers.insert(find(name) + 1, list(new))
    for name, new in replace:
        wrappers[find(name)] = list(new)
    for name in delete:
        del wrappers[find(name)]
    return wrappers
