"""forward(), step() and step_n(): forward dynamics, one physics substep and
a run of them, batched over envs.

Counterpart of `robogym_tpu/physics/step.py`. Per substep (MuJoCo's Euler
pipeline): kinematics -> com quantities -> CRB -> tendons -> collision ->
transmission -> velocity pass -> RNE bias -> actuation -> passive ->
the fused constraint solve with the implicit-damping Euler velocity update
-> qpos integration. A model that cannot take the fused solve (no contact
slots) runs the unfused sequence instead: `forward_tail` (M^-1,
qacc_smooth, the constraint solve) and `euler`.
"""

from __future__ import annotations

import numpy as np
import torch

from robogym_torch.mjcf.model import Data, JointType, Model, env_col
from robogym_torch.physics import actuation as actuation_lib
from robogym_torch.physics import constraint as constraint_lib
from robogym_torch.physics import factor_kernel, smooth, tables
from robogym_torch.physics.collision import driver as collision_driver
from robogym_torch.physics.tables import on_device
from robogym_torch.utils import rotation as rot


def fwd_position(m: Model, d: Data) -> Data:
    d = smooth.kinematics(m, d)
    d = smooth.com_pos(m, d)
    d = smooth.crb(m, d)
    d = smooth.tendon(m, d)
    d = collision_driver.collision(m, d, m.opt.group_cap)
    return d


def fwd_velocity(m: Model, d: Data) -> Data:
    d, cdofdot = smooth.com_vel(m, d)
    return smooth.rne(m, d, cdofdot)


def _xfrc_to_qfrc(m: Model, d: Data) -> torch.Tensor:
    """Body cartesian wrenches (xfrc_applied) mapped into joint space."""
    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    if c.nbody == 0:
        return torch.zeros_like(d.qvel)
    mask = on_device(c, "body_dof_mask", c.body_dof_mask, dev, dtype)
    rc = d.subtree_com[:, on_device(c, "body_rootid", np.asarray(c.body_rootid, np.int64),
                                    dev, torch.long)]
    offset = d.xipos - rc
    torque, force = d.xfrc_applied[..., :3], d.xfrc_applied[..., 3:]
    Fm = torch.einsum("bv,xbk->xvk", mask, force)
    Cm = torch.einsum("bv,xbk->xvk", mask, rot.cross(offset, force))
    Tm = torch.einsum("bv,xbk->xvk", mask, torque)
    return (torch.sum(d.cdof[..., 3:] * Fm, dim=-1)
            + torch.sum(d.cdof[..., :3] * (Cm + Tm), dim=-1))


def integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor, dt) -> torch.Tensor:
    """qpos += qvel * dt with quaternion handling (mj_integratePos); dt
    is one timestep (0-dim) or each env's (B,)."""
    c = m.const
    dt1, dt2 = env_col(dt, 1), env_col(dt, 2)
    dev = qpos.device
    st = tables.scalar_joint_tables(c)

    def ix(key, arr):
        return on_device(c, "ip_" + key, np.asarray(arr, np.int64), dev, torch.long)

    out = qpos.clone()
    if len(st["qadr"]):
        qadr = ix("qadr", st["qadr"])
        out[:, qadr] = qpos[:, qadr] + qvel[:, ix("dadr", st["dadr"])] * dt1
    free = [(q, dd) for jt, q, dd in st["quat"] if jt == JointType.FREE]
    ball = [(q, dd) for jt, q, dd in st["quat"] if jt == JointType.BALL]
    if free:
        qa = np.asarray([q for q, _ in free])
        da = np.asarray([dd for _, dd in free])
        lin_q = ix("free_lq", qa[:, None] + np.arange(3))
        out[:, lin_q] = qpos[:, lin_q] + qvel[:, ix("free_ld", da[:, None] + np.arange(3))] * dt2
        quat_q = ix("free_qq", qa[:, None] + 3 + np.arange(4))
        w = qvel[:, ix("free_qd", da[:, None] + 3 + np.arange(3))]
        out[:, quat_q] = rot.quat_integrate(qpos[:, quat_q], w, dt2)
    if ball:
        qa = np.asarray([q for q, _ in ball])
        da = np.asarray([dd for _, dd in ball])
        quat_q = ix("ball_qq", qa[:, None] + np.arange(4))
        w = qvel[:, ix("ball_qd", da[:, None] + np.arange(3))]
        out[:, quat_q] = rot.quat_integrate(qpos[:, quat_q], w, dt2)
    return out


def forward_smooth(m: Model, d: Data):
    """A substep up to the constraint solve: positions, contacts,
    velocities, actuation and passive forces. Returns (Data, qfrc_smooth)."""
    d = fwd_position(m, d)
    d, moment = smooth.transmission(m, d)
    d = fwd_velocity(m, d)
    d = actuation_lib.actuation(m, d, moment)
    d = smooth.passive(m, d)
    qfrc_smooth = (d.qfrc_passive + d.qfrc_actuator + d.qfrc_applied - d.qfrc_bias
                   + _xfrc_to_qfrc(m, d))
    return d, qfrc_smooth


def forward_tail(m: Model, d: Data, qfrc_smooth: torch.Tensor) -> Data:
    """The unfused dynamics tail: M^-1 (one SPD-inverse kernel),
    qacc_smooth and the constraint solve."""
    Minv = factor_kernel.spd_inverse(d.qM.contiguous())
    return constraint_lib.solve(m, d.replace(qacc_smooth=smooth.mv(Minv, qfrc_smooth)), Minv)


def forward(m: Model, d: Data) -> Data:
    """Forward dynamics (mj_forward): fills every derived field, qacc
    included, without advancing the state."""
    d, qfrc_smooth = forward_smooth(m, d)
    return forward_tail(m, d, qfrc_smooth)


def euler(m: Model, d: Data) -> Data:
    """Semi-implicit Euler with implicit joint damping (mj_Euler):
    qvel += dt * (M + dt*diag(damping))^-1 M qacc, the inverse applied with
    one refinement step, then qpos integration."""
    dt = m.opt.timestep
    qfrc_total = smooth.mv(d.qM, d.qacc)
    M_imp = d.qM + env_col(dt, 2) * torch.diag_embed(m.dof_damping + d.act_vel_damping)
    Minv_imp = factor_kernel.spd_inverse(M_imp.contiguous())
    qacc_imp = smooth.mv(Minv_imp, qfrc_total)
    qacc_imp = qacc_imp + smooth.mv(Minv_imp, qfrc_total - smooth.mv(M_imp, qacc_imp))
    qvel_new = d.qvel + env_col(dt, 1) * qacc_imp
    return d.replace(qpos=integrate_pos(m, d.qpos, qvel_new, dt), qvel=qvel_new, time=d.time + dt)


def step(m: Model, d: Data) -> Data:
    """One physics substep: forward dynamics, the fused constraint + Euler
    velocity solve, and qpos integration; without contact slots,
    `forward_tail` and `euler`."""
    d, qfrc_smooth = forward_smooth(m, d)
    dt = m.opt.timestep
    res = constraint_lib.solve_fused_step(m, d, qfrc_smooth)
    if res is None:
        return euler(m, forward_tail(m, d, qfrc_smooth))
    d, qvel_new = res
    qpos_new = integrate_pos(m, d.qpos, qvel_new, dt)
    return d.replace(qpos=qpos_new, qvel=qvel_new, time=d.time + dt)


def step_n(m: Model, d: Data, n: int) -> Data:
    """`n` substeps (the reference's sim.step(nsubsteps))."""
    for _ in range(n):
        d = step(m, d)
    return d
