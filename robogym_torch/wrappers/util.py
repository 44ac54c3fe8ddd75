"""Utility transforms, batched (counterpart of `robogym_tpu/wrappers/util.py`;
reference robogym/wrappers/util.py:10-343)."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from robogym_torch.utils import rotation as rot
from robogym_torch.wrappers.core import Transform


def bin_array(lower, upper, n_bins: int, spacing: str = "linear") -> np.ndarray:
    """(util.py:17-33 BinSpacing.get_bin_array)."""
    if spacing == "linear":
        return np.linspace(lower, upper, n_bins)
    assert lower == -upper and n_bins % 2 == 1, (
        "Exponential binning needs a symmetric space and odd bins"
    )
    half = np.array([2.0 ** (-n) for n in range(n_bins // 2)]) * lower
    return np.concatenate([half, [0], -half[::-1]])


class DiscretizeActionWrapper(Transform):
    """Continuous [-1,1]^A -> MultiDiscrete(n_bins) (util.py:36-72). The
    wrapped step takes integer bin indices (B, A)."""

    DEFAULT_BINS = 11

    def __init__(self, env=None, n_action_bins: Optional[int] = DEFAULT_BINS,
                 bin_spacing: str = "linear"):
        if n_action_bins is None:
            n_action_bins = self.DEFAULT_BINS
        self.n_action_bins = n_action_bins
        self._bins = np.stack([bin_array(-1.0, 1.0, n_action_bins, bin_spacing)]
                              * env.action_size)

    def action(self, tstate, action, draws, env, env_state):
        bins = torch.as_tensor(self._bins, dtype=env.dtype, device=action.device)
        idx = torch.clamp(action.to(torch.int32), 0, bins.shape[1] - 1).long()
        return tstate, torch.gather(bins.expand(action.shape[0], -1, -1), 2, idx[..., None])[..., 0]


class ClipActionWrapper(Transform):
    """(util.py:124-139)."""

    def __init__(self, env=None, clip: float = 1.0):
        self._clip = clip

    def action(self, tstate, action, draws, env, env_state):
        return tstate, torch.clamp(action, -self._clip, self._clip)


class ClipObservationWrapper(Transform):
    """(util.py:91-110)."""

    def __init__(self, env=None, clip: float = 100.0):
        self._clip = clip

    def observation(self, tstate, obs, draws, env, env_state):
        return tstate, {k: torch.clamp(v, -self._clip, self._clip) for k, v in obs.items()}


class ClipRewardWrapper(Transform):
    """(util.py:113-127)."""

    def __init__(self, env=None, clip: float = 100.0):
        self._clip = clip

    def reward(self, tstate, reward):
        return tstate, torch.clamp(reward, -self._clip, self._clip)


class SummedRewardsWrapper(Transform):
    """Reward triple -> its sum (B, 1) (util.py:337-343)."""

    def __init__(self, env=None):
        pass

    def reward(self, tstate, reward):
        return tstate, torch.sum(reward, dim=-1, keepdim=True)


class SmoothActionWrapper(Transform):
    """EMA action filter with per-episode alpha (util.py:192-218; alpha
    adjusted by step duration / 0.08)."""

    def __init__(self, env=None, alpha: float = 0.0):
        self._alpha = alpha
        self._step_duration = env.constants.step_duration

    def init(self, draws, env, batch):
        adjusted = np.power(self._alpha, self._step_duration / 0.08) if self._alpha > 0 else 0.0
        dev = env.device
        return {"alpha": torch.full((batch,), adjusted, dtype=env.dtype, device=dev),
                "value": torch.zeros((batch, env.action_size), dtype=env.dtype, device=dev),
                "t": torch.zeros(batch, dtype=torch.int32, device=dev)}

    def action(self, tstate, action, draws, env, env_state):
        a = tstate["alpha"][:, None]
        value = tstate["value"] * a + (1.0 - a) * action
        t = tstate["t"] + 1
        # bias-corrected EMA (IncrementalExpAvg, util.py:142-160)
        corrected = value / (1.0 - torch.pow(a, t.to(value.dtype)[:, None]))
        corrected = torch.where(a > 0.0, corrected, action)
        return {"alpha": tstate["alpha"], "value": value, "t": t}, corrected

    def observation(self, tstate, obs, draws, env, env_state):
        a = tstate["alpha"][:, None]
        t = torch.clamp(tstate["t"], min=1).to(tstate["value"].dtype)[:, None]
        ema = tstate["value"] / (1.0 - torch.pow(a, t))
        ema = torch.where(a > 0.0, ema, tstate["value"])
        return tstate, dict(obs, action_ema=ema)


class PreviousActionObservationWrapper(Transform):
    """(util.py:164-184)."""

    def __init__(self, env=None):
        self._n = env.action_size

    def init(self, draws, env, batch):
        return torch.zeros((batch, self._n), dtype=env.dtype, device=env.device)

    def action(self, tstate, action, draws, env, env_state):
        return action.to(env.dtype), action

    def observation(self, tstate, obs, draws, env, env_state):
        return tstate, dict(obs, previous_action=tstate)


class RelativeGoalWrapper(Transform):
    """Adds achieved_goal_* / relative_goal_* (and their noisy variants)
    (util.py:221-285): quaternion keys by quat_difference, others by
    subtraction."""

    def __init__(self, env=None, obs_prefix: str = ""):
        self.obs_prefix = obs_prefix

    def observation(self, tstate, obs, draws, env, env_state):
        obs = dict(obs)
        goal_names = [k[len("goal_"):] for k in obs if k.startswith("goal_")
                      and not k.startswith("goal_is_achieved")]

        def diff(name, goal, cur):
            return rot.quat_difference(goal, cur) if name.endswith("quat") else goal - cur

        for name in goal_names:
            cur_key = f"{self.obs_prefix}{name}"
            if cur_key not in obs:
                continue
            goal, cur = obs[f"goal_{name}"], obs[cur_key]
            obs[f"achieved_goal_{name}"] = cur
            obs[f"relative_goal_{name}"] = diff(name, goal, cur)
            noisy_key = f"noisy_{cur_key}"
            if noisy_key in obs:
                obs[f"noisy_achieved_goal_{name}"] = obs[noisy_key]
                obs[f"noisy_relative_goal_{name}"] = diff(name, goal, obs[noisy_key])
        return tstate, obs


class UnifiedGoalObservationWrapper(Transform):
    """Concatenate goal pieces into flat goal vectors (util.py:288-334)."""

    def __init__(self, env=None, goal_keys=("relative_goal", "achieved_goal", "goal"),
                 goal_parts=("pos", "quat")):
        self.goal_keys = list(goal_keys)
        self.goal_parts = list(goal_parts)

    def observation(self, tstate, obs, draws, env, env_state):
        obs = dict(obs)
        for goal_key in self.goal_keys:
            for prefix in ("", "noisy_"):
                parts = [obs[f"{prefix}{goal_key}_{p}"] for p in self.goal_parts
                         if f"{prefix}{goal_key}_{p}" in obs]
                if parts:
                    obs[f"{prefix}{goal_key}"] = torch.cat(
                        [p.reshape(p.shape[0], -1) for p in parts], dim=-1)
        return tstate, obs


class RewardObservationWrapper(Transform):
    """Expose (selected) reward entries as an observation
    (reference wrappers/dactyl.py RewardObservationWrapper)."""

    def __init__(self, env=None, reward_inds: Optional[Sequence[int]] = None):
        self.reward_inds = list(reward_inds) if reward_inds is not None else None

    def init(self, draws, env, batch):
        n = len(self.reward_inds) if self.reward_inds is not None else 3
        return torch.zeros((batch, n), dtype=env.dtype, device=env.device)

    def reward(self, tstate, reward):
        sel = reward[:, self.reward_inds] if self.reward_inds is not None else reward
        return sel.to(tstate.dtype), reward

    def observation(self, tstate, obs, draws, env, env_state):
        return tstate, dict(obs, reward=tstate)


class RewardNameWrapper(Transform):
    """Sets the default reward names on the env (util.py:73-88): the
    reward is the [env, goal, success] triple."""

    def __init__(self, env=None):
        if not hasattr(env, "reward_names"):
            env.reward_names = ["env", "goal", "success"]
