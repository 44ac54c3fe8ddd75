"""The observation provider framework, batched.

Counterpart of `robogym_tpu/observation/common.py` (reference
observation/common.py:8-127): providers refresh their data at a `SyncType`
cadence, and an observation is a cheap read of provider data. A provider
is a function `(env, EnvState) -> dict of (B, ...) tensors` with a
cadence; `ObservationStack` stages the reads, so that values of the RESET
and RESET_GOAL cadences are read once and carried in the env state
instead of being read again every step (the reference's caching,
robot_env.py:273-301). Unlike the JAX package's stack, the cache holds
no entry for a STEP provider: nothing here needs its structure fixed.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Dict, Optional

import torch


class SyncType(enum.Enum):
    """(observation/common.py:8-33): how often a provider's data refreshes."""

    STEP = 0
    RESET_GOAL = 1
    RESET = 2


@dataclasses.dataclass(frozen=True)
class ObservationProvider:
    """A named read of (env, state), with its cadence."""

    name: str
    read: Callable[[Any, Any], Any]
    sync_type: SyncType = SyncType.STEP


def _scatter(old, envs: torch.Tensor, new):
    """`old` (a tree of (B, ...) tensors) with rows `envs` from `new`."""
    if isinstance(old, dict):
        return {k: _scatter(v, envs, new[k]) for k, v in old.items()}
    return old.index_put((envs,), new)


class ObservationStack:
    """Stages provider reads by cadence.

    A RESET or RESET_GOAL provider is read into a cache at reset, and a
    RESET_GOAL one again at a goal reset; a STEP provider is read at
    observe time only, and has no cache entry. The cache rides in the env
    state's `goal_aux`, which keeps the reference's staleness (goal
    images, observation/goal.py:46-82)."""

    def __init__(self, providers: Dict[str, ObservationProvider]):
        self.providers = dict(providers)

    def sync(self, env, state, cached: Optional[Dict] = None,
             sync_type: SyncType = SyncType.STEP, envs: Optional[torch.Tensor] = None
             ) -> Dict[str, Any]:
        """The cache after a sync at `sync_type`: a RESET or RESET_GOAL
        provider is read where its cadence is due at this sync level, or
        where the cache has no entry yet (the first reset). With `envs`
        (k,), `state` holds those envs only, and their rows of the cached
        entries are replaced; no other row is copied."""
        out = dict(cached or {})
        for name, p in self.providers.items():
            if p.sync_type == SyncType.STEP:
                continue
            if sync_type.value <= p.sync_type.value or name not in out:
                fresh = p.read(env, state)
                out[name] = fresh if envs is None or name not in out else \
                    _scatter(out[name], envs, fresh)
        return out
