"""Dactyl and cube transforms, batched (counterpart of
`robogym_tpu/wrappers/dactyl.py`; reference robogym/wrappers/dactyl.py:14-226
and wrappers/cube.py:12-182)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from robogym_torch.envs.core import uniform_apply
from robogym_torch.envs.dactyl import cube_env as cube_env_lib
from robogym_torch.robot import shadow_hand as hand_lib
from robogym_torch.wrappers.core import Transform
from robogym_torch.wrappers.randomizations import (
    FreezingPhasespaceMarkers,
    _freeze_params,
    _freeze_step,
    _ix,
    loguniform_apply,
    rand,
    rand_exponential,
    randn,
)


class FixedWristWrapper(Transform):
    """Servo the WRJ0 wrist joint to a fixed position
    (wrappers/dactyl.py:173-188); WRJ0 is action 1 in ACTUATORS order."""

    WRJ0_ACTION_INDEX = 1

    def __init__(self, env=None, wrj0_pos: float = 0.0):
        self.wrj0_pos = wrj0_pos
        self.hand = env.hand

    def action(self, tstate, action, draws, env, env_state):
        aid = int(self.hand.actuator_ids[self.WRJ0_ACTION_INDEX])
        cr = env.model.actuator_ctrlrange[aid]
        arange = (cr[1] - cr[0]) / 2.0
        joint_pos = env_state.physics.qpos[:, int(self.hand.joint_qpos_ids[1])]  # WRJ0
        action = action.clone()
        action[:, self.WRJ0_ACTION_INDEX] = ((self.wrj0_pos - joint_pos) / arange).to(action.dtype)
        return tstate, action


class StopOnFallWrapper(Transform):
    """done and a drop penalty when the cube leaves the palm
    (wrappers/cube.py:106-160): the penalty on the first drop frame only,
    done held back before `min_episode_length`."""

    def __init__(self, env=None, drop_reward: float = -20.0, min_episode_length: int = -1):
        self.drop_reward = drop_reward
        self.min_episode_length = min_episode_length

    def init(self, draws, env, batch):
        z = torch.zeros(batch, dtype=torch.int32, device=env.device)
        return {"steps": z, "drops_so_far": z, "first_drop": z,
                "fell": torch.zeros(batch, dtype=torch.bool, device=env.device)}

    def reward(self, tstate, reward):
        first = tstate["fell"] & (tstate["first_drop"] == 0)
        drop = torch.where(first, self.drop_reward, 0.0).to(reward.dtype)
        reward = reward.clone()
        reward[:, 0] = reward[:, 0] + drop
        return tstate, reward

    def observation(self, tstate, obs, draws, env, env_state):
        fell = ~cube_env_lib.is_on_palm(env.cube, env_state.physics)
        first = fell & (tstate["first_drop"] == 0)
        tstate = dict(tstate, fell=fell,
                      drops_so_far=tstate["drops_so_far"] + fell.to(torch.int32),
                      first_drop=torch.where(first, tstate["steps"] + 1, tstate["first_drop"]),
                      steps=tstate["steps"] + 1)
        return tstate, dict(obs, fell_down=fell[:, None].to(env.dtype))

    def done(self, tstate, done, env, env_state):
        done = done | tstate["fell"]
        if self.min_episode_length > 0:
            done = done & (tstate["steps"] >= self.min_episode_length)
        return tstate, done


class AngleObservationWrapper(Transform):
    """*_angle keys -> [cos, sin] (wrappers/cube.py:162-182)."""

    def __init__(self, env=None):
        pass

    def observation(self, tstate, obs, draws, env, env_state):
        obs = dict(obs)
        for k in list(obs):
            if k.endswith("_angle"):
                obs[k] = torch.cat([torch.cos(obs[k]), torch.sin(obs[k])], dim=-1)
        return tstate, obs


class RandomizedCubeSizeWrapper(Transform):
    """Cube geom sizes (and the bodies of a multi-part cube) scaled by one
    U[cube_size_range] draw an episode (wrappers/cube.py:12-53)."""

    model_fields = ("geom_size", "body_pos")

    def __init__(self, env=None, cube_size_range=(0.95, 1.05)):
        self.cube_size_range = cube_size_range
        names = env.model.const.names["geom"]
        self.geom_ids = np.asarray([names[g] for g in ("cube:middle", "cube:top", "cube:bottom")
                                    if g in names], np.int64)
        bnames = env.model.const.names["body"]
        self.body_ids = np.asarray([bnames[b] for b in ("cube:top", "cube:bottom")
                                    if b in bnames], np.int64)

    def draw_model(self, gen, batch, env):
        return {"u": rand(gen, (batch,), env)}

    def model(self, tstate, fields, draws):
        scale = uniform_apply(draws["u"], *self.cube_size_range)[:, None, None]
        gs = fields["geom_size"].clone()
        g = _ix(self.geom_ids, gs.device)
        gs[:, g] = gs[:, g] * scale
        fields = dict(fields, geom_size=gs)
        if len(self.body_ids):
            bp = fields["body_pos"].clone()
            b = _ix(self.body_ids, bp.device)
            bp[:, b] = bp[:, b] * scale
            fields["body_pos"] = bp
        return fields


class RandomizedWindWrapper(Transform):
    """Random impulse forces on the cube body (wrappers/cube.py:56-85): a
    per-episode hit probability; each step the force decays by 0.99, or a
    new gaussian impulse replaces it, in `xfrc_applied`."""

    has_physics_hook = True

    def __init__(self, env=None, force_std: float = 1.0, max_mean_time_between: float = 0.8):
        self.force_std = force_std
        self.max_mean_time_between = max_mean_time_between
        self._step_duration = env.constants.step_duration
        self.cube_body = int(env.model.const.names["body"]["cube:middle"])
        self._cube_mass = float(env.model.body_mass[self.cube_body])

    def draw_init(self, gen, batch, env):
        return {"u": rand(gen, (batch,), env)}

    def init(self, draws, env, batch):
        lo = 0.01 * self._step_duration / self.max_mean_time_between
        hi = self._step_duration / self.max_mean_time_between
        return {"hit_prob": loguniform_apply(draws["u"], lo, hi)}

    def draw_physics(self, gen, batch, env):
        return {"hit_u": rand(gen, (batch,), env), "n": randn(gen, (batch, 3), env)}

    def physics(self, tstate, physics, draws, env):
        xf = physics.xfrc_applied.clone()
        decayed = xf[:, self.cube_body, :3] * 0.99
        hit = draws["hit_u"] < tstate["hit_prob"]
        impulse = draws["n"].to(xf.dtype) * self._cube_mass * self.force_std
        xf[:, self.cube_body, :3] = torch.where(hit[:, None], impulse, decayed)
        return tstate, physics.replace(xfrc_applied=xf)


class RandomizedPhasespaceFingersWrapper(Transform):
    """Perturb the fingertip and phasespace reference sites in the model
    (wrappers/dactyl.py:14-50)."""

    model_fields = ("site_pos",)

    def __init__(self, env=None, fingertips_noise: float = 0.003,
                 reference_noise: float = 0.001):
        names = env.model.const.names["site"]
        sites, noises = [], []
        for s in cube_env_lib.REFERENCE_SITE_NAMES:
            sites.append(names["robot0:" + s])
            noises.append(reference_noise)
        for s in hand_lib.FINGERTIP_SITE_NAMES:
            sites.append(names["robot0:" + s])
            noises.append(fingertips_noise)
        self.site_ids = np.asarray(sites, np.int64)
        self.noise = np.asarray(noises)

    def draw_model(self, gen, batch, env):
        return {"n": randn(gen, (batch, len(self.site_ids), 3), env)}

    def model(self, tstate, fields, draws):
        sp = fields["site_pos"].clone()
        scale = torch.as_tensor(self.noise, dtype=sp.dtype, device=sp.device)[:, None]
        ids = _ix(self.site_ids, sp.device)
        sp[:, ids] = sp[:, ids] + draws["n"] * scale
        return dict(fields, site_pos=sp)


class FingersFreezingPhasespaceMarkers(FreezingPhasespaceMarkers):
    """(wrappers/dactyl.py:96-106)."""

    def __init__(self, env=None, key="fingertip_pos", disappear_p_1s=0.2, freeze_scale_s=1.0):
        super().__init__(env, key=key, disappear_p_1s=disappear_p_1s,
                         freeze_scale_s=freeze_scale_s)


class FreezingPhasespaceBody(Transform):
    """Freeze a set of observation keys together for a geometric number of
    steps (randomizations.py:473-513)."""

    def __init__(self, env=None, keys: Sequence[str] = (), disappear_p_1s=0.02,
                 freeze_scale_s=1.0):
        self.keys = list(keys)
        self._disappear_p, self._freeze_scale_steps = _freeze_params(env, disappear_p_1s,
                                                                     freeze_scale_s)

    def init(self, draws, env, batch):
        return None   # set at the first observation that holds one of the keys

    def draw_observation(self, gen, batch, env, tstate, obs):
        if not any(k in obs for k in self.keys):
            return None
        return {"start_u": rand(gen, (batch,), env), "exp": rand_exponential(gen, (batch,), env)}

    def observation(self, tstate, obs, draws, env, env_state):
        obs = dict(obs)
        present = [k for k in self.keys if k in obs]
        if not present:
            return tstate, obs
        if tstate is None:
            B = obs[present[0]].shape[0]
            tstate = {"freeze_left": torch.zeros(B, dtype=torch.int32, device=env.device),
                      "held": {k: obs[k] for k in present}}
        frozen, left = _freeze_step(tstate["freeze_left"], draws["start_u"], draws["exp"],
                                    self._disappear_p, self._freeze_scale_steps)
        held = {k: torch.where(frozen.view((-1,) + (1,) * (obs[k].dim() - 1)),
                               tstate["held"][k], obs[k]) for k in present}
        obs.update(held)
        return {"freeze_left": left, "held": held}, obs


class CubeFreezingPhasespaceBody(FreezingPhasespaceBody):
    """(wrappers/cube.py:88-103)."""

    def __init__(self, env=None, disappear_p_1s=0.02, freeze_scale_s=1.0):
        super().__init__(env, keys=[
            "noisy_relative_goal_pos", "noisy_relative_goal_quat",
            "noisy_relative_goal_face_angle", "noisy_achieved_goal_pos",
            "noisy_achieved_goal_quat", "noisy_achieved_goal_face_angle", "noisy_cube_pos",
        ], disappear_p_1s=disappear_p_1s, freeze_scale_s=freeze_scale_s)


class FingersOccludedPhasespaceMarkers(Transform):
    """Hold fingertip markers while the finger is occluded
    (wrappers/dactyl.py:53-93). The worlds have no occlusion-annotation
    geoms, so this is a pass-through, as the reference is when
    `occlusion_markers_exist` is False."""

    def __init__(self, env=None):
        pass


class FingerSeparationWrapper(Transform):
    """Immobilize and spread apart every finger but `active_finger`
    (wrappers/dactyl.py:109-151): each frozen joint's range collapses to a
    0.01 rad window at one limit. A deterministic per-episode transform of
    jnt_range."""

    model_fields = ("jnt_range",)

    FINGERS = ("TH", "FF", "MF", "RF", "LF", "WR")

    def __init__(self, env=None, active_finger="FF"):
        self.active_finger = active_finger
        jn = env.model.const.names["joint"]
        finger_i = self.FINGERS.index(active_finger)
        plan = []  # (joint id, limit side)
        for i, f in enumerate(self.FINGERS):
            if i == finger_i:
                continue
            if "F" in f:
                limit = 0 if i < finger_i else 1
                sides = ((f"{f}J4", 1), (f"{f}J3", limit), (f"{f}J2", 1), (f"{f}J1", 1),
                         (f"{f}J0", 1))
            elif f == "TH":
                sides = ((f"{f}J4", 0), (f"{f}J3", 1), (f"{f}J2", 1), (f"{f}J1", 0), (f"{f}J0", 0))
            else:
                sides = ()
            plan += [(jn[f"robot0:{j}"], side) for j, side in sides if f"robot0:{j}" in jn]
        self.joint_ids = np.asarray([p[0] for p in plan], np.int64)
        self.sides = np.asarray([p[1] for p in plan], np.int64)

    def model(self, tstate, fields, draws):
        jr = fields["jnt_range"].clone()
        ids = _ix(self.joint_ids, jr.device)
        sides = _ix(self.sides, jr.device)
        other = jr[:, ids, 1 - sides]
        diff = torch.where(sides == 0, -0.01, 0.01).to(jr.dtype)
        jr[:, ids, sides] = other + diff
        return dict(fields, jnt_range=jr)
