"""Domain-randomization transforms, batched.

Counterpart of `robogym_tpu/wrappers/randomizations.py` (reference
robogym/wrappers/randomizations.py): model randomization (inertia,
friction, gravity, timestep, wind, damping, kp, joint limits, tendon
ranges), observation corruption (noise, delay, phasespace freezing) and
action corruption (noise, latency, backlash, broken actuators, delay).
Each transform's `draw_<hook>` makes the samples of its distributions for
the batch; the hook applies them as the JAX transform applies its own.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from robogym_torch.envs.core import uniform_apply
from robogym_torch.mjcf.model import TrnType
from robogym_torch.utils import rotation as rot
from robogym_torch.wrappers.core import Transform

# empirical constant: quaternion noise at Euler-radian scale
# (randomizations.py:310-312)
QUAT_NOISE_CORRECTION = 1.96


def rand(gen, shape, env) -> torch.Tensor:
    """Uniform [0, 1) draws in the env's dtype, on its device."""
    return torch.rand(shape, generator=gen, dtype=env.dtype, device=env.device)


def randn(gen, shape, env) -> torch.Tensor:
    """Standard normal draws in the env's dtype, on its device."""
    return torch.randn(shape, generator=gen, dtype=env.dtype, device=env.device)


def rand_exponential(gen, shape, env) -> torch.Tensor:
    """Exponential (rate 1) draws in the env's dtype, on its device."""
    return torch.empty(shape, dtype=env.dtype, device=env.device).exponential_(generator=gen)


def loguniform_apply(u: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """exp of `uniform_apply` between log(low) and log(high), the logs in
    u's dtype (the JAX package's `loguniform`)."""
    lo, hi = (torch.log(torch.tensor(v, dtype=u.dtype, device=u.device)) for v in (low, high))
    return torch.exp(uniform_apply(u, lo, hi))


def _ix(ids, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids, np.int64), device=device)


# ---------------------------------------------------------------------------
# model randomization (per episode)
# ---------------------------------------------------------------------------


class RandomizedBodyInertiaWrapper(Transform):
    """body_inertia *= U[mass_range] (randomizations.py:72-92)."""

    model_fields = ("body_inertia",)

    def __init__(self, env=None, mass_range=(0.5, 1.5)):
        self.mass_range = mass_range
        self._nbody = env.model.const.nbody

    def draw_model(self, gen, batch, env):
        return {"u": rand(gen, (batch, self._nbody, 1), env)}

    def model(self, tstate, fields, draws):
        mult = uniform_apply(draws["u"], *self.mass_range)
        return dict(fields, body_inertia=fields["body_inertia"] * mult)


class RandomizedFrictionBaseWrapper(Transform):
    """geom_friction[:, col] *= loguniform(multiplier_ranges[col]) for the
    geoms whose names start with the prefix (randomizations.py:95-153)."""

    model_fields = ("geom_friction",)

    def __init__(self, env, multiplier_ranges, geom_name_prefix=None):
        self.multiplier_ranges = np.asarray(multiplier_ranges, np.float64)
        assert self.multiplier_ranges.shape == (3, 2)
        names = env.model.const.names["geom"]
        ids = sorted(gid for name, gid in names.items()
                     if geom_name_prefix is None or name.startswith(geom_name_prefix))
        self.geom_ids = np.asarray(ids, np.int64)

    def draw_model(self, gen, batch, env):
        return {"u": rand(gen, (batch, 3), env)}

    def model(self, tstate, fields, draws):
        fr = fields["geom_friction"].clone()
        ids = _ix(self.geom_ids, fr.device)
        for col in range(3):
            lo, hi = self.multiplier_ranges[col]
            mult = loguniform_apply(draws["u"][:, col], lo, hi)
            fr[:, ids, col] = fr[:, ids, col] * mult[:, None]
        return dict(fields, geom_friction=fr)


class RandomizedFrictionWrapper(RandomizedFrictionBaseWrapper):
    """(randomizations.py:156-159)."""

    def __init__(self, env=None, multiplier_range=(0.7, 1.3)):
        super().__init__(env, [list(multiplier_range)] * 3, "robot0:")


class RandomizedRobotFrictionWrapper(RandomizedFrictionBaseWrapper):
    """(randomizations.py:162-166)."""

    def __init__(self, env=None, multiplier_ranges=((0.7, 1.3), (0.5, 1.5), (0.5, 1.5))):
        super().__init__(env, multiplier_ranges, "robot0:")


class RandomizedCubeFrictionWrapper(RandomizedFrictionBaseWrapper):
    """(randomizations.py:169-173)."""

    def __init__(self, env=None, multiplier_ranges=((0.5, 1.5), (0.2, 5.0), (0.2, 5.0))):
        super().__init__(env, multiplier_ranges, "cube:")


class RandomizedGravityWrapper(Transform):
    """gravity += std * N(0,1)^3 (randomizations.py:176-191)."""

    model_fields = ("opt:gravity",)

    def __init__(self, env=None, gravity_std=0.4):
        self.gravity_std = gravity_std

    def draw_model(self, gen, batch, env):
        return {"n": randn(gen, (batch, 3), env)}

    def model(self, tstate, fields, draws):
        return dict(fields, **{"opt:gravity": fields["opt:gravity"]
                               + self.gravity_std * draws["n"]})


class RandomizedTimestepWrapper(Transform):
    """Per-step exponential timestep noise with a sign-flip process
    (randomizations.py:194-305)."""

    model_fields = ("opt:timestep",)

    def __init__(self, env=None, min_lambda=1250, max_lambda=10000, adr_bias_magic=0.6,
                 adr_variance_magic=1.0):
        self.min_lambda = min_lambda
        self.max_lambda = max_lambda
        self._orig_timestep = float(env.model.opt.timestep)

    def draw_init(self, gen, batch, env):
        return {k: rand(gen, (batch,), env)
                for k in ("pos_lambda", "neg_lambda", "side", "p_flip_pos", "p_flip_neg")}

    def init(self, draws, env, batch):
        lam = (self.min_lambda, self.max_lambda)
        one = torch.ones_like(draws["side"])
        return {
            "pos_lambda": uniform_apply(draws["pos_lambda"], *lam),
            "neg_lambda": uniform_apply(draws["neg_lambda"], *lam),
            "side": torch.where(draws["side"] < 0.5, one, -one),   # a fair Bernoulli draw
            "p_flip_pos": draws["p_flip_pos"],
            "p_flip_neg": draws["p_flip_neg"],
        }

    def draw_model_step(self, gen, batch, env):
        return {"flip_u": rand(gen, (batch,), env), "exp": rand_exponential(gen, (batch,), env)}

    def model_step(self, tstate, model_fields, draws, env):
        side = tstate["side"]
        p_flip = torch.where(side > 0, tstate["p_flip_pos"], tstate["p_flip_neg"])
        side = torch.where(draws["flip_u"] > p_flip, -side, side)
        lam = torch.where(side > 0, tstate["pos_lambda"], tstate["neg_lambda"])
        noise = draws["exp"] / lam
        orig = self._orig_timestep
        # negative side: rescaled and clipped for stability
        frac = noise / orig
        neg_noise = torch.clamp(orig * (frac / (1 + frac)), 0.0, orig / 2)
        noise = torch.where(side > 0, noise, neg_noise)
        model_fields = dict(model_fields or {})
        model_fields["opt:timestep"] = (orig + side * noise).to(env.dtype)
        return dict(tstate, side=side), model_fields


class RandomizedWindWrapper(Transform):
    """Per-episode wind vector: N(0, std)^3 added to model.opt.wind."""

    model_fields = ("opt:wind",)

    def __init__(self, env=None, wind_std=0.3):
        self.wind_std = wind_std

    def draw_model(self, gen, batch, env):
        return {"n": randn(gen, (batch, 3), env)}

    def model(self, tstate, fields, draws):
        return dict(fields, **{"opt:wind": fields["opt:wind"] + self.wind_std * draws["n"]})


class RandomizedDampingWrapper(Transform):
    """dof_damping *= loguniform(damping_range) for the dofs of the
    selected joints (randomizations.py:562-590)."""

    model_fields = ("dof_damping",)

    def __init__(self, env=None, damping_range=(0.3, 3.0), joint_names=()):
        self.damping_range = damping_range
        c = env.model.const
        jn = c.names["joint"]
        jids = set(jn[n] for n in joint_names) if joint_names else set(jn.values())
        dof_jntid = np.asarray(c.dof_jntid)
        self.dof_ids = np.asarray([i for i in range(c.nv) if int(dof_jntid[i]) in jids], np.int64)

    def draw_model(self, gen, batch, env):
        return {"u": rand(gen, (batch, len(self.dof_ids)), env)}

    def model(self, tstate, fields, draws):
        mult = loguniform_apply(draws["u"], *self.damping_range)
        damp = fields["dof_damping"].clone()
        ids = _ix(self.dof_ids, damp.device)
        damp[:, ids] = damp[:, ids] * mult
        return dict(fields, dof_damping=damp)


class RandomizedRobotDampingWrapper(RandomizedDampingWrapper):
    """(wrappers/dactyl.py RandomizedRobotDampingWrapper)."""

    def __init__(self, env=None, damping_range=(0.3, 3.0)):
        names = [n for n in env.model.const.names["joint"] if n.startswith("robot0:")]
        super().__init__(env, damping_range, names)


class RandomizedKpWrapper(Transform):
    """actuator kp (gainprm[:, 0]) *= loguniform(kp_range)
    (randomizations.py:720-746)."""

    model_fields = ("actuator_gainprm",)

    def __init__(self, env=None, kp_range=(0.75, 1.5), actuator_names=()):
        self.kp_range = kp_range
        an = env.model.const.names["actuator"]
        ids = [an[n] for n in actuator_names] if actuator_names else list(an.values())
        self.actuator_ids = np.asarray(sorted(ids), np.int64)

    def draw_model(self, gen, batch, env):
        return {"u": rand(gen, (batch, len(self.actuator_ids)), env)}

    def model(self, tstate, fields, draws):
        mult = loguniform_apply(draws["u"], *self.kp_range)
        gp = fields["actuator_gainprm"].clone()
        ids = _ix(self.actuator_ids, gp.device)
        gp[:, ids, 0] = gp[:, ids, 0] * mult
        return dict(fields, actuator_gainprm=gp)


class RandomizedRobotKpWrapper(RandomizedKpWrapper):
    def __init__(self, env=None, kp_range=(0.75, 1.5)):
        names = [n for n in env.model.const.names["actuator"] if n.startswith("robot0:")]
        super().__init__(env, kp_range, names)


def _ordered(new: torch.Tensor) -> torch.Tensor:
    """Ranges (..., 2) with their ends in order."""
    return torch.stack([torch.minimum(new[..., 0], new[..., 1]),
                        torch.maximum(new[..., 0], new[..., 1])], dim=-1)


class RandomizedJointLimitWrapper(Transform):
    """Joint limits moved by gaussian noise relative to their width, and
    the control ranges of the actuators that drive those joints set to
    them (randomizations.py:593-670, simplified to a 1:1 joint:actuator
    mapping)."""

    model_fields = ("jnt_range", "actuator_ctrlrange")

    def __init__(self, env=None, joint_names=(), relative_std=0.15):
        self.relative_std = relative_std
        c = env.model.const
        jn = c.names["joint"]
        self.joint_ids = np.asarray(sorted(jn[n] for n in joint_names) if joint_names
                                    else sorted(jn.values()), np.int64)
        trnid = np.asarray(c.actuator_trnid)
        trntype = np.asarray(c.actuator_trntype)
        # joint id -> actuator id where the actuator transmits to that joint
        self.jnt_to_act = {int(trnid[a]): a for a in range(c.nu)
                           if int(trntype[a]) == TrnType.JOINT}

    def draw_model(self, gen, batch, env):
        return {"n": randn(gen, (batch, len(self.joint_ids), 2), env)}

    def model(self, tstate, fields, draws):
        jr = fields["jnt_range"].clone()
        ids = _ix(self.joint_ids, jr.device)
        orig = jr[:, ids]
        width = orig[..., 1] - orig[..., 0]
        jr[:, ids] = _ordered(orig + width[..., None] * self.relative_std * draws["n"])
        cr = fields["actuator_ctrlrange"].clone()
        for j in self.joint_ids.tolist():
            if j in self.jnt_to_act:
                cr[:, self.jnt_to_act[j]] = jr[:, j]
        return dict(fields, jnt_range=jr, actuator_ctrlrange=cr)


class RandomizedTendonRangeWrapper(Transform):
    """Tendon ranges moved by gaussian noise relative to their width
    (randomizations.py:673-717)."""

    model_fields = ("tendon_range",)

    def __init__(self, env=None, relative_std=0.15):
        self.relative_std = relative_std
        self._ntendon = env.model.const.ntendon

    def draw_model(self, gen, batch, env):
        return {"n": randn(gen, (batch, self._ntendon, 2), env)}

    def model(self, tstate, fields, draws):
        tr = fields["tendon_range"]
        if tr.shape[1] == 0:
            return fields
        width = tr[..., 1] - tr[..., 0]
        return dict(fields, tendon_range=_ordered(tr + width[..., None] * self.relative_std
                                                  * draws["n"]))


# ---------------------------------------------------------------------------
# observation corruption
# ---------------------------------------------------------------------------


class RandomizeObservationWrapper(Transform):
    """noisy_<key> = obs with additive and multiplicative per-episode
    biases and uncorrelated per-step noise; a quaternion is turned by an
    angle-axis perturbation instead (randomizations.py:314-400). The
    biases are drawn at the first observation, which gives their shapes."""

    def __init__(self, env=None, levels: Optional[Dict] = None):
        self.levels = dict(levels or {})

    @staticmethod
    def _key_len(key, obs):
        return 1 if key.endswith("_quat") else obs[key].shape[-1]

    def init(self, draws, env, batch):
        return {}

    def draw_observation(self, gen, batch, env, tstate, obs):
        if not self.levels:
            return None
        out = {"uncorrelated": {k: randn(gen, (batch, self._key_len(k, obs)), env)
                                for k in sorted(self.levels)},
               "axis": {k: rand(gen, (batch, 3), env) for k in sorted(self.levels)
                        if k.endswith("_quat")}}
        if "additive" not in tstate:
            for name in ("additive", "multiplicative"):
                out[name] = {k: randn(gen, (batch, self._key_len(k, obs)), env)
                             for k in sorted(self.levels)}
        return out

    def observation(self, tstate, obs, draws, env, env_state):
        obs = dict(obs)
        if not self.levels:
            return tstate, obs
        if "additive" not in tstate:
            lv = self.levels
            tstate = dict(tstate,
                          additive={k: draws["additive"][k] * lv[k].get("additive", 0.0)
                                    for k in sorted(lv)},
                          multiplicative={k: 1.0 + draws["multiplicative"][k]
                                          * lv[k].get("multiplicative", 0.0) for k in sorted(lv)})
        for k in sorted(self.levels):
            uncorr = draws["uncorrelated"][k] * self.levels[k].get("uncorrelated", 0.0)
            additive = tstate["additive"][k] + uncorr
            v = obs[f"noisy_{k}" if f"noisy_{k}" in obs else k]
            if not k.endswith("_quat"):
                v = v * tstate["multiplicative"][k] + additive
            else:
                axis = uniform_apply(draws["axis"][k], -1.0, 1.0)
                angle = additive[:, 0] * QUAT_NOISE_CORRECTION
                nq = rot.quat_from_angle_and_axis(angle, axis / rot.norm(axis, keepdim=True))
                v = rot.quat_normalize(rot.quat_mul(v, nq))
            obs[f"noisy_{k}"] = v
        return tstate, obs


class ObservationDelayWrapper(Transform):
    """Group-wise gaussian observation delay over a rolling buffer with
    linear, quaternion or radian interpolation
    (randomizations.py:1032-1161)."""

    MAXLEN = 10

    def __init__(self, env=None, levels: Optional[Dict] = None):
        levels = levels or {"interpolators": {}, "groups": {}}
        self.groups = levels.get("groups", {})
        self.interpolators = levels.get("interpolators", {})
        self.obs_names = sorted({n for g in self.groups.values() for n in g["obs_names"]})

    def init(self, draws, env, batch):
        return {"count": torch.zeros(batch, dtype=torch.int32, device=env.device)}

    def _interpolate(self, name, x1, x2, t):
        kind = self.interpolators.get(name, "LinearInterpolator")
        if kind == "QuatInterpolator":
            return rot.quat_average2(x1, x2, t)
        t = t.reshape(t.shape + (1,) * (x1.dim() - 1))
        if kind == "RadianInterpolator":
            diff = rot.normalize_angles(x2 - x1)
            return rot.normalize_angles(x2 - t * diff)
        return x1 * t + x2 * (1 - t)

    def draw_observation(self, gen, batch, env, tstate, obs):
        if not self.groups:
            return None
        return {"delay": {g: randn(gen, (batch,), env) for g in sorted(self.groups)}}

    def observation(self, tstate, obs, draws, env, env_state):
        obs = dict(obs)
        if not self.groups:
            return tstate, obs
        if "buffers" not in tstate:
            # rolling buffer seeded with the current obs
            bufs = {n: obs[n][:, None].expand((-1, self.MAXLEN) + obs[n].shape[1:]).clone()
                    for n in self.obs_names}
            tstate = {"count": torch.ones_like(tstate["count"]), "buffers": bufs}
        else:
            bufs = {n: torch.cat([tstate["buffers"][n][:, 1:], obs[n][:, None]], dim=1)
                    for n in self.obs_names}
            tstate = {"count": tstate["count"] + 1, "buffers": bufs}
        count = torch.clamp(tstate["count"], max=self.MAXLEN)
        bi = torch.arange(count.shape[0], device=count.device)
        for name in sorted(self.groups):
            group = self.groups[name]
            delay = group["mean"] + group["std"] * draws["delay"][name]
            delay = torch.clamp(delay, torch.zeros_like(delay), (count - 1).to(delay.dtype))
            delay_l = torch.floor(delay).long()
            delay_h = torch.ceil(delay).long()
            t = delay - delay_l.to(delay.dtype)
            for obs_name in group["obs_names"]:
                buf = tstate["buffers"][obs_name]
                obs_l = buf[bi, self.MAXLEN - 1 - delay_l]
                obs_h = buf[bi, self.MAXLEN - 1 - delay_h]
                obs[f"noisy_{obs_name}"] = self._interpolate(obs_name, obs_h, obs_l, t)
        return tstate, obs


def _freeze_params(env, disappear_p_1s, freeze_scale_s):
    """(per-step probability that a marker freezes, its mean freeze
    length in steps)."""
    step_s = env.constants.step_duration
    return 1.0 - (1.0 - disappear_p_1s) ** step_s, freeze_scale_s / step_s


def _freeze_step(freeze_left, start_u, exp, disappear_p, scale):
    """(frozen before this step, freeze steps left after it) from the
    step's Bernoulli and exponential draws."""
    duration = torch.ceil(exp * scale).to(torch.int32)
    frozen = freeze_left > 0
    left = torch.where(frozen, freeze_left - 1,
                       torch.where(start_u < disappear_p, duration, torch.zeros_like(duration)))
    return frozen, left


class FreezingPhasespaceMarkers(Transform):
    """Each marker of `key` freezes (holds its stale value) for a geometric
    number of steps (randomizations.py:400-470)."""

    def __init__(self, env=None, key="fingertip_pos", disappear_p_1s=0.02, freeze_scale_s=1.0):
        self.key = key
        self._disappear_p, self._freeze_scale_steps = _freeze_params(env, disappear_p_1s,
                                                                     freeze_scale_s)

    def init(self, draws, env, batch):
        return None   # set at the first observation, which gives the markers

    def draw_observation(self, gen, batch, env, tstate, obs):
        n = obs[self.key].shape[-1] // 3
        return {"start_u": rand(gen, (batch, n), env), "exp": rand_exponential(gen, (batch, n), env)}

    def observation(self, tstate, obs, draws, env, env_state):
        obs = dict(obs)
        src = f"noisy_{self.key}" if f"noisy_{self.key}" in obs else self.key
        v = obs[src]
        B = v.shape[0]
        cur = v.reshape(B, -1, 3)
        if tstate is None:
            tstate = {"freeze_left": torch.zeros(cur.shape[:2], dtype=torch.int32,
                                                 device=v.device), "held": cur}
        frozen, left = _freeze_step(tstate["freeze_left"], draws["start_u"], draws["exp"],
                                    self._disappear_p, self._freeze_scale_steps)
        held = torch.where(frozen[..., None], tstate["held"], cur)
        obs[f"noisy_{self.key}"] = held.reshape(B, -1).to(v.dtype)
        return {"freeze_left": left, "held": held}, obs


# ---------------------------------------------------------------------------
# action corruption
# ---------------------------------------------------------------------------


class ActionNoiseWrapper(Transform):
    """Multiplicative and additive per-episode biases, uncorrelated
    per-step noise (randomizations.py:749-782)."""

    def __init__(self, env=None, multiplicative=0.03, additive=0.03, uncorrelated=0.1):
        self.multiplicative = multiplicative
        self.additive = additive
        self.uncorrelated = uncorrelated

    def draw_init(self, gen, batch, env):
        return {k: randn(gen, (batch, env.action_size), env) for k in ("mult", "add")}

    def init(self, draws, env, batch):
        return {"mult": 1.0 + draws["mult"] * self.multiplicative,
                "add": draws["add"] * self.additive}

    def draw_action(self, gen, batch, env):
        return {"noise": randn(gen, (batch, env.action_size), env)}

    def action(self, tstate, action, draws, env, env_state):
        return tstate, (action * tstate["mult"] + tstate["add"]
                        + draws["noise"] * self.uncorrelated)


class RandomizedActionLatency(Transform):
    """Per-coordinate action delay of 0..max_delay steps
    (randomizations.py:516-560)."""

    def __init__(self, env=None, max_delay=1):
        self.max_delay = max_delay

    def draw_init(self, gen, batch, env):
        return {"delay": torch.randint(0, self.max_delay + 1, (batch, env.action_size),
                                       generator=gen, device=env.device).to(torch.int32)}

    def init(self, draws, env, batch):
        return {"history": torch.zeros((batch, self.max_delay + 1, env.action_size),
                                       dtype=env.dtype, device=env.device),
                "delay": draws["delay"]}

    def action(self, tstate, action, draws, env, env_state):
        history = torch.cat([action[:, None], tstate["history"][:, :-1]], dim=1)
        new_action = torch.gather(history, 1, tstate["delay"].long()[:, None])[:, 0]
        return dict(tstate, history=history), new_action

    def observation(self, tstate, obs, draws, env, env_state):
        h = tstate["history"][:, :-1]
        return tstate, dict(obs, action_history=h.reshape(h.shape[0], -1),
                            action_delay=tstate["delay"].to(env.dtype))


class RandomizedBrokenActuatorWrapper(Transform):
    """Broken actuators output white noise (randomizations.py:1163-1215);
    at most `max_broken_actuators` break, the first by index."""

    def __init__(self, env=None, proba_broken=0.001, max_broken_actuators=2, uncorrelated=0.05):
        self.proba_broken = proba_broken
        self.max_broken = max_broken_actuators
        self.uncorrelated = uncorrelated

    def draw_init(self, gen, batch, env):
        return {"u": rand(gen, (batch, env.action_size), env)}

    def init(self, draws, env, batch):
        broken = draws["u"] < self.proba_broken
        return broken & (torch.cumsum(broken.to(torch.int32), dim=-1) <= self.max_broken)

    def draw_action(self, gen, batch, env):
        return {"u": rand(gen, (batch, env.action_size), env)}

    def action(self, tstate, action, draws, env, env_state):
        return tstate, torch.where(tstate, draws["u"].to(action.dtype) * self.uncorrelated, action)


class BacklashWrapper(Transform):
    """Tendon-slack backlash integrator in control space
    (randomizations.py:785-943), through the Shadow Hand's actuator-joint
    coupling; reads the env's compiled model, as the JAX transform does."""

    COEF_DOWN_LOG = np.array([
        4.25, 4.25, 2.93, 4.25, 4.25, 4.25, 4.25, 1.92, 4.25, 3.35,
        4.25, 4.25, 4.25, 3.87, 1.39, 4.25, 1.25, 4.25, 4.25, 4.25,
    ])
    COEF_UP_LOG = np.array([
        4.25, 4.25, 4.25, 4.25, 1.86, 4.25, 4.25, 1.44, 4.25, 2.98,
        2.07, 4.25, 4.25, 2.94, 1.41, 2.82, 1.53, 4.25, 2.86, 2.10,
    ])

    def __init__(self, env=None, std=0.1):
        self.std = std
        self.hand = env.hand
        self._step_duration = env.constants.step_duration

    def draw_init(self, gen, batch, env):
        return {k: randn(gen, (batch, 20), env) for k in ("down", "up")}

    def init(self, draws, env, batch):
        out = {"slack": torch.zeros((batch, 20), dtype=env.dtype, device=env.device)}
        for k, coef in (("down", self.COEF_DOWN_LOG), ("up", self.COEF_UP_LOG)):
            c = torch.as_tensor(coef, dtype=env.dtype, device=env.device)
            out[k] = torch.clamp(torch.exp(c * (1.0 + draws[k] * self.std)), min=2.0)
        return out

    def action(self, tstate, action, draws, env, env_state):
        from robogym_torch.robot import shadow_hand as hand_lib

        m, d, idx = env.model, env_state.physics, self.hand
        ids = _ix(idx.actuator_ids, action.device)
        # the ctrl the env would apply for this action
        full_ctrl = hand_lib.denormalize_position_control(
            idx, m, d, action, relative_action=env.constants.relative_action)
        ctrl = full_ctrl[:, ids]
        # qpos -> ctrl sums the coupled J1 + J0 (randomizations.py:929-941)
        qpos_as_ctrl = hand_lib.joint_positions_to_control(hand_lib.joint_positions(idx, d))

        dt = self._step_duration
        diff = ctrl - qpos_as_ctrl
        eps = 1e-5
        incr = ((diff < -eps).to(diff.dtype) * diff * tstate["down"] * dt
                + (diff > eps).to(diff.dtype) * diff * tstate["up"] * dt)
        alpha = torch.clamp(torch.abs(torch.sign(diff) - tstate["slack"])
                            / (torch.abs(incr) + 1e-12), 0.0, 1.0)
        new_ctrl = alpha * qpos_as_ctrl + (1.0 - alpha) * ctrl
        slack = torch.clamp(tstate["slack"] + incr, -1.0, 1.0)

        # ctrl -> normalized action (randomizations.py:922-928)
        cr = m.actuator_ctrlrange[ids]
        arange = (cr[:, 1] - cr[:, 0]) / 2.0
        center = qpos_as_ctrl if env.constants.relative_action else (cr[:, 1] + cr[:, 0]) / 2.0
        return dict(tstate, slack=slack), (new_ctrl - center) / arange


class ActionDelayWrapper(Transform):
    """Fractional (sub-step) action delay
    (randomizations.py:943-1031), as the JAX package models it: the
    time-weighted blend of the last and the new action for the whole step,
    with the reference's delay sampling (per-episode gaussian scale,
    per-step jitter, clipped to 5-100 % of the step)."""

    def __init__(self, env=None, delay=30.0, per_episode_std=0.1, per_step_std=0.002):
        self.delay = delay
        self.per_episode_std = per_episode_std
        self.per_step_std = per_step_std
        self.total_length_ms = float(env.constants.step_duration) * 1000.0

    def draw_init(self, gen, batch, env):
        return {"n": randn(gen, (batch,), env)}

    def init(self, draws, env, batch):
        dev = env.device
        return {"ep_delay": self.delay * (1.0 + draws["n"] * self.per_episode_std),
                "last_action": torch.zeros((batch, env.action_size), dtype=env.dtype, device=dev),
                "has_last": torch.zeros(batch, dtype=torch.bool, device=dev)}

    def draw_action(self, gen, batch, env):
        return {"n": randn(gen, (batch,), env)}

    def action(self, tstate, action, draws, env, env_state):
        last = torch.where(tstate["has_last"][:, None], tstate["last_action"], action)
        delay = tstate["ep_delay"] * (1.0 + draws["n"].to(action.dtype) * self.per_step_std)
        clipped = torch.clamp(delay, 0.05 * self.total_length_ms, self.total_length_ms)
        frac = torch.where(delay > 1e-4, clipped / self.total_length_ms,
                           torch.zeros_like(delay))[:, None]
        blended = frac * last + (1.0 - frac) * action
        return (dict(tstate, last_action=action, has_last=torch.ones_like(tstate["has_last"])),
                blended.to(action.dtype))

