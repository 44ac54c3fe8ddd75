"""Actuation: fixed-gain / affine actuators and the user-gain PID and
cascaded-PI position controllers (mujoco-py's `set_pid_control`).

Counterpart of `robogym_tpu/physics/actuation.py`, batched over envs.
Controller state lives in `Data.act`: PID actuators keep [integral,
previous error, smoothed derivative]; cascaded-PI actuators keep
[position integral, velocity integral, smoothed desired velocity,
previous error].
"""

from __future__ import annotations

import numpy as np
import torch

from robogym_torch.mjcf.model import BiasType, Data, GainType, Model, env_col
from robogym_torch.physics.tables import on_device


def _actuator_partition(c):
    """Static partition of actuator ids: (pid_ids, pid_actadr, cas_ids,
    cas_actadr, plain_ids, plain_affine_mask), cached on the ModelConst.
    user[0] == 1 selects the cascaded-PI controller."""
    key = "_actuation_partition"
    cached = getattr(c, key, None)
    if cached is not None:
        return cached
    gt = np.asarray(c.actuator_gaintype)
    bt = np.asarray(c.actuator_biastype)
    user = np.asarray(c.actuator_user)
    is_user = (gt == GainType.USER) | (bt == BiasType.USER)
    is_cas = is_user & (user == 1.0)
    is_pid = is_user & ~is_cas
    pid_ids = np.nonzero(is_pid)[0].astype(np.int64)
    cas_ids = np.nonzero(is_cas)[0].astype(np.int64)
    plain_ids = np.nonzero(~is_user)[0].astype(np.int64)
    pid_actadr = np.asarray(c.actuator_actadr)[pid_ids].astype(np.int64)
    cas_actadr = np.asarray(c.actuator_actadr)[cas_ids].astype(np.int64)
    plain_affine = bt[plain_ids] == BiasType.AFFINE
    out = (pid_ids, pid_actadr, cas_ids, cas_actadr, plain_ids, plain_affine)
    object.__setattr__(c, key, out)
    return out


def actuation(m: Model, d: Data, moment: torch.Tensor) -> Data:
    """Actuator forces, qfrc_actuator, the new controller state and the
    velocity-feedback damping folded into the implicit Euler solve."""
    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    B = d.qpos.shape[0]
    if c.nu == 0:
        return d.replace(qfrc_actuator=torch.zeros((B, c.nv), dtype=dtype, device=dev))

    def ix(key, arr):
        return on_device(c, "act_" + key, arr, dev, torch.long)

    ctrl = d.ctrl
    limited = on_device(c, "act_ctrllimited", c.actuator_ctrllimited, dev)
    cr = m.actuator_ctrlrange
    ctrl = torch.where(limited, torch.minimum(torch.maximum(ctrl, cr[..., 0]), cr[..., 1]), ctrl)

    dt = env_col(m.opt.timestep, 1)
    (pid_ids, pid_actadr, cas_ids, cas_actadr,
     plain_ids, plain_affine) = _actuator_partition(c)
    force = torch.zeros((B, c.nu), dtype=dtype, device=dev)
    act_new = d.act.clone()

    def clip(x, lo, hi):
        return torch.minimum(torch.maximum(x, lo), hi)

    if len(pid_ids):
        ids, aadr = ix("pid", pid_ids), ix("pid_adr", pid_actadr)
        gp = m.take("actuator_gainprm", ids)
        kp, ti, imax, td, dsmooth, deadband = (gp[..., i] for i in range(6))
        length = d.actuator_length[:, ids]
        integral = d.act[:, aadr]
        prev_err = d.act[:, aadr + 1]
        dsm_prev = d.act[:, aadr + 2]

        error = ctrl[:, ids] - length
        error = torch.where(torch.abs(error) < deadband, torch.zeros_like(error), error)
        integral = integral + error * dt
        zero = torch.zeros_like(kp)
        iterm_limit = torch.where(ti > 1e-12, imax * ti / torch.clamp(kp, min=1e-12), zero)
        integral = clip(integral, -iterm_limit, iterm_limit)
        deriv_raw = (error - prev_err) / torch.clamp(dt, min=1e-12)
        dsm = dsmooth * dsm_prev + (1.0 - dsmooth) * deriv_raw
        iterm = torch.where(ti > 1e-12, kp * integral / torch.clamp(ti, min=1e-12),
                            torch.zeros_like(integral))
        force[:, ids] = kp * error + iterm + kp * td * dsm
        act_new[:, aadr] = integral
        act_new[:, aadr + 1] = error
        act_new[:, aadr + 2] = dsm

    if len(cas_ids):
        ids, aadr = ix("cas", cas_ids), ix("cas_adr", cas_actadr)
        gp = m.take("actuator_gainprm", ids)
        kp, ti, iclamp = gp[..., 0], gp[..., 1], gp[..., 2]
        kvp, tiv, iclamp_v = gp[..., 5], gp[..., 6], gp[..., 7]
        ema, max_vel = gp[..., 8], gp[..., 9]
        zero = torch.zeros_like(kp)

        length = d.actuator_length[:, ids]
        velocity = d.actuator_velocity[:, ids]
        int_pos = d.act[:, aadr]
        int_vel = d.act[:, aadr + 1]
        smooth_prev = d.act[:, aadr + 2]

        error = ctrl[:, ids] - length
        int_pos = int_pos + error * dt
        ip_limit = torch.where(ti > 1e-12, iclamp * ti / torch.clamp(kp, min=1e-12), zero)
        int_pos = clip(int_pos, -ip_limit, ip_limit)
        iterm_pos = torch.where(ti > 1e-12, kp * int_pos / torch.clamp(ti, min=1e-12),
                                torch.zeros_like(int_pos))
        des_vel = kp * error + iterm_pos
        des_vel = ema * smooth_prev + (1.0 - ema) * des_vel
        smooth_new = des_vel
        des_vel = clip(des_vel, -max_vel, max_vel)

        verror = des_vel - velocity
        int_vel = int_vel + verror * dt
        int_vel = clip(int_vel, -iclamp_v, iclamp_v)
        iterm_vel = torch.where(tiv > 1e-12, kvp * int_vel / torch.clamp(tiv, min=1e-12),
                                torch.zeros_like(int_vel))
        force[:, ids] = kvp * verror + iterm_vel
        act_new[:, aadr] = int_pos
        act_new[:, aadr + 1] = int_vel
        act_new[:, aadr + 2] = smooth_new
        act_new[:, aadr + 3] = error

    if len(plain_ids):
        ids = ix("plain", plain_ids)
        gain = m.take("actuator_gainprm", ids)[..., 0]
        f = gain * ctrl[:, ids]
        bias = (
            m.actuator_biasprm[ids, 0]
            + m.actuator_biasprm[ids, 1] * d.actuator_length[:, ids]
            + m.actuator_biasprm[ids, 2] * d.actuator_velocity[:, ids]
        )
        affine = on_device(c, "act_plain_affine", plain_affine, dev)
        force[:, ids] = f + torch.where(affine, bias, torch.zeros_like(bias))

    flimited = on_device(c, "act_forcelimited", c.actuator_forcelimited, dev)
    force = torch.where(flimited, clip(force, m.actuator_forcerange[:, 0], m.actuator_forcerange[:, 1]),
                        force)
    qfrc_actuator = torch.einsum("xuv,xu->xv", moment, force)

    act_vel_damping = torch.zeros((B, c.nv), dtype=dtype, device=dev)
    if len(cas_ids):
        ids = ix("cas", cas_ids)
        kvp_all = m.take("actuator_gainprm", ids)[..., 5]
        mom2 = moment[:, ids] ** 2
        act_vel_damping = act_vel_damping + (kvp_all[..., None] * mom2).sum(1)

    return d.replace(
        actuator_force=force, qfrc_actuator=qfrc_actuator, act=act_new,
        act_vel_damping=act_vel_damping,
    )
