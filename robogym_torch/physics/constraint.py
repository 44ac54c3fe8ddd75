"""Soft-constraint assembly and the fused hot-path solve.

Counterpart of `robogym_tpu/physics/constraint.py` for the path
`step` takes: MuJoCo's constraint model (solref/solimp impedances,
pyramidal friction cones, joint and tendon limits, dof friction loss)
minimized over qacc by preconditioned nonlinear CG. `solve_fused_step`
picks the `opt.ncon_active` deepest contact slots, gathers their data and
hands everything to `constraint_batched.fused_step_core`, which runs the two
SPD-inverse kernels and the fused CG kernel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from robogym_torch.mjcf.model import Data, Model
from robogym_torch.physics import tables
from robogym_torch.physics.collision import driver as collision_driver
from robogym_torch.physics.tables import on_device

BIG = 1e10

# row kinds
EQ = 0
ONESIDED = 1
FRICTION = 2

# line-search safeguard scales around the frozen-active-set Newton step
LS_SCALES = (2.0, 1.0, 0.5, 0.125)


def _impedance(solimp: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """MuJoCo mj_makeImpedance: position-dependent impedance in (0, 1)."""
    d0 = torch.clamp(solimp[..., 0], 0.0001, 0.9999)
    dmax = torch.clamp(solimp[..., 1], 0.0001, 0.9999)
    width = torch.clamp(solimp[..., 2], min=1e-10)
    mid = torch.clamp(solimp[..., 3], 0.0001, 0.9999)
    power = torch.clamp(solimp[..., 4], min=1.0)
    x = torch.clamp(torch.abs(pos) / width, 0.0, 1.0)
    a = 1.0 / torch.pow(mid, power - 1.0)
    b = 1.0 / torch.pow(1.0 - mid, power - 1.0)
    y = torch.where(x <= mid, a * torch.pow(x, power), 1.0 - b * torch.pow(1.0 - x, power))
    return d0 + y * (dmax - d0)


def _ref_kb(solref: torch.Tensor, solimp: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stiffness/damping from solref (standard or direct), with the row's
    dmax = solimp[1] as MuJoCo's mj_makeRef uses it."""
    timeconst = solref[..., 0]
    dampratio = solref[..., 1]
    dmax = torch.clamp(solimp[..., 1], 0.0001, 0.9999)
    standard = timeconst > 0
    b_std = 2.0 / torch.clamp(dmax * timeconst, min=1e-10)
    k_std = 1.0 / torch.clamp(dmax * dmax * timeconst * timeconst * dampratio * dampratio, min=1e-10)
    b = torch.where(standard, b_std, -dampratio)
    k = torch.where(standard, k_std, -timeconst)
    return k, b


def scalar_blocks(m: Model, d: Data):
    """Non-contact constraint rows: dof friction, joint limits, tendon
    limits. Returns (J (B, n, nv), pos (B, n), solref (B, n, 2),
    solimp (B, n, 5), floss (B, n), active (B, n), kind (n,) numpy,
    diagA (n,) numpy)."""
    from robogym_torch.physics.setconst import invweight0

    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    B, nv = d.qpos.shape[0], c.nv
    if c.neq:
        raise NotImplementedError("equality constraints are not ported yet")
    dof_iw0, _, ten_iw0 = invweight0(m)

    def ex(t):
        return t.expand((B,) + tuple(t.shape))

    def ix(key, arr):
        return on_device(c, "sb_" + key, np.asarray(arr, np.int64), dev, torch.long)

    blocks = []
    fl_ids = np.nonzero(np.asarray(c.dof_has_frictionloss))[0]
    if len(fl_ids):
        n = len(fl_ids)
        onehot = np.zeros((n, nv), np.float32)
        onehot[np.arange(n), fl_ids] = 1.0
        ids = ix("fl", fl_ids)
        blocks.append((
            ex(on_device(c, "sb_fl_onehot", onehot, dev, dtype)),
            torch.zeros((B, n), dtype=dtype, device=dev),
            ex(m.dof_solref[ids]), ex(m.dof_solimp[ids]), ex(m.dof_frictionloss[ids]),
            torch.ones((B, n), dtype=torch.bool, device=dev),
            np.full(n, FRICTION, np.int32), dof_iw0[fl_ids],
        ))

    st = tables.scalar_joint_tables(c)
    lim = st["lim_rows"]
    if len(lim):
        jids_np, dadr_np = st["jid"][lim], st["dadr"][lim]
        n = len(jids_np)
        jids = ix("lim_j", jids_np)
        qv = d.qpos[:, ix("lim_q", st["qadr"][lim])]
        dist_lo = qv - m.jnt_range[jids, 0]
        dist_hi = m.jnt_range[jids, 1] - qv
        dist = torch.minimum(dist_lo, dist_hi)
        sign = torch.where(dist_lo < dist_hi, torch.ones_like(dist), -torch.ones_like(dist))
        onehot = np.zeros((n, nv), np.float32)
        onehot[np.arange(n), dadr_np] = 1.0
        blocks.append((
            on_device(c, "sb_lim_onehot", onehot, dev, dtype) * sign[..., None],
            dist - m.jnt_margin[jids],
            ex(m.jnt_solref[jids]), ex(m.jnt_solimp[jids]),
            torch.zeros((B, n), dtype=dtype, device=dev),
            dist < m.jnt_margin[jids],
            np.full(n, ONESIDED, np.int32), dof_iw0[dadr_np],
        ))

    lt_np = np.nonzero(np.asarray(c.tendon_limited))[0]
    if len(lt_np):
        lt = ix("ten", lt_np)
        L = d.ten_length[:, lt]
        dist_lo = L - m.tendon_range[lt, 0]
        dist_hi = m.tendon_range[lt, 1] - L
        dist = torch.minimum(dist_lo, dist_hi)
        sign = torch.where(dist_lo < dist_hi, torch.ones_like(dist), -torch.ones_like(dist))
        blocks.append((
            d.ten_J[:, lt] * sign[..., None],
            dist - m.tendon_margin[lt],
            ex(m.tendon_solref[lt]), ex(m.tendon_solimp[lt]),
            torch.zeros((B, len(lt_np)), dtype=dtype, device=dev),
            dist < m.tendon_margin[lt],
            np.full(len(lt_np), ONESIDED, np.int32), ten_iw0[lt_np],
        ))

    if blocks:
        cat = lambda i: torch.cat([b[i] for b in blocks], dim=1)
        return (cat(0), cat(1), cat(2), cat(3), cat(4), cat(5),
                np.concatenate([b[6] for b in blocks]),
                np.concatenate([np.asarray(b[7], np.float64) for b in blocks]))
    z = lambda *s: torch.zeros((B,) + s, dtype=dtype, device=dev)
    return (z(0, nv), z(0), z(0, 2), z(0, 5), z(0),
            torch.zeros((B, 0), dtype=torch.bool, device=dev),
            np.zeros(0, np.int32), np.zeros(0, np.float64))


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, n, ...) rows at idx (B, k) -> (B, k, ...)."""
    bi = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[bi, idx]


def _post_gather_prelude(m: Model, d: Data):
    """Contact-slot selection and gather for the fused core. Returns None
    when the model has no contact slots."""
    c = m.const
    con = d.contact
    ncon = con.dist.shape[1]
    S = min(m.opt.ncon_active, ncon)
    if ncon == 0 or S <= 0:
        return None
    dev, dtype = d.qpos.device, d.qpos.dtype
    condims = np.asarray(collision_driver.contact_slot_layout(c, m.opt.group_cap), np.int32)
    nfacet = {1: 1, 3: 4, 4: 6, 6: 10}[int(condims.max())]

    J_s, pos_s, solref_s, solimp_s, floss_s, active_s, kind_s, diagA_s = scalar_blocks(m, d)

    # the S deepest slots; inactive slots score BIG and ties go to the lower
    # slot index, as lax.top_k does
    score = torch.where(con.active, con.dist - con.includemargin,
                        torch.full_like(con.dist, BIG))
    sel = torch.sort(score, dim=-1, stable=True).indices[:, :S]
    pos_c = _take(con.pos, sel)
    normal_c = _take(con.normal, sel)
    dist_c = _take(con.dist, sel)
    margin_c = _take(con.includemargin, sel)
    cd_sel = _take(con.condim, sel)
    act_c = _take(con.active, sel)
    b1 = _take(con.body1, sel).long()
    b2 = _take(con.body2, sel).long()
    wrow = on_device(c, "slot_winner_rows",
                     collision_driver.slot_winner_rows(c, m.opt.group_cap), dev, torch.long)
    wg = _take(con.wtab, wrow[sel])                                    # (B, S, 12)
    solref_c, solimp_c, fric_c = wg[..., 0:2], wg[..., 2:7], wg[..., 7:12]
    frame_c = collision_driver.contact_frame(normal_c)                 # (B, S, 3, 3)

    dofmask = on_device(c, "body_dof_mask", c.body_dof_mask, dev, dtype)
    rootcom = d.subtree_com[:, on_device(c, "body_rootid", np.asarray(c.body_rootid, np.int64),
                                         dev, torch.long)]
    from robogym_torch.physics.setconst import invweight0_tensors

    _, body_iw0, _ = invweight0_tensors(m)
    bw_trn = body_iw0[:, 0]
    scale = 4.0 / torch.clamp(m.opt.impratio, min=1e-6)
    iw_c = scale * (bw_trn[b1] + bw_trn[b2])
    head = (
        J_s, pos_s, solref_s, solimp_s, floss_s, active_s.to(dtype),
        torch.as_tensor(diagA_s, dtype=dtype, device=dev),
        pos_c, frame_c, dist_c, margin_c, fric_c, act_c, cd_sel, iw_c,
        dofmask[b1], dofmask[b2], _take(rootcom, b1), _take(rootcom, b2),
        solref_c, solimp_c, d.cdof, d.qvel, d.qM,
    )
    return head, sel, S, nfacet, np.asarray(kind_s, np.int32), J_s.shape[1]


def kind_masked_D(kind: np.ndarray, D: torch.Tensor):
    """(Deq, Done, Dfr): D (..., E) masked by the static row kinds."""
    kind = np.asarray(kind, np.int32)
    outs = []
    for want in (EQ, ONESIDED, FRICTION):
        mask = torch.as_tensor(kind == want, device=D.device)
        outs.append(torch.where(mask, D, torch.zeros_like(D)))
    return tuple(outs)


def _mv(A, x):
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def _scan_cg_solve(J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, iterations: int):
    """M^-1-preconditioned Polak-Ribière+ nonlinear CG on the soft-
    constraint cost with a frozen-active-set Newton line search (the JAX
    package's reference solve), batched over a leading env axis:
    J (B, E, V), row vectors (B, E), M/Minv (B, V, V), qs/x0 (B, V).
    Returns (qacc (B, V), efc_force (B, E))."""

    def force(jar):
        neg = (jar < 0).to(jar.dtype)
        return Deq * jar + Done * jar * neg + torch.minimum(torch.maximum(Dfr * jar, -floss), floss)

    def penalty_cost(jar):
        neg = (jar < 0).to(jar.dtype)
        c_quad = 0.5 * (Deq + Done * neg) * jar * jar
        inside = (torch.abs(Dfr * jar) < floss).to(jar.dtype)
        quad_f = 0.5 * Dfr * jar * jar
        lin_f = floss * torch.abs(jar) - 0.5 * floss * floss / torch.clamp(Dfr, min=1e-12)
        c_fric = inside * quad_f + (1.0 - inside) * lin_f
        return torch.sum(c_quad + c_fric, dim=-1)

    def grad(x, jar):
        return _mv(M, x - qs) + _mv(J.transpose(-1, -2), force(jar))

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    x = x0
    jar = _mv(J, x0) - aref
    g = grad(x0, jar)
    Mg = _mv(Minv, g)
    p = -Mg
    for _ in range(iterations):
        Jp = _mv(J, p)
        dx0 = x - qs
        Mp = _mv(M, p)
        c1 = dot(dx0, Mp)
        c2 = dot(p, Mp)
        f0 = force(jar)
        neg = (jar < 0).to(x.dtype)
        inside = (torch.abs(Dfr * jar) < floss).to(x.dtype)
        deff = Deq + Done * neg + Dfr * inside
        phi_p = c1 + dot(f0, Jp)
        phi_pp = torch.clamp(c2 + dot(deff * Jp, Jp), min=1e-12)
        a1 = torch.clamp(-phi_p / phi_pp, 0.0, 2.0)
        pen0 = penalty_cost(jar)
        best_cost = torch.zeros_like(c1)
        best_a = torch.zeros_like(c1)
        for s in LS_SCALES:
            a = a1 * s
            dcost = a * c1 + 0.5 * a * a * c2 + penalty_cost(jar + a[:, None] * Jp) - pen0
            take = dcost < best_cost
            best_cost = torch.where(take, dcost, best_cost)
            best_a = torch.where(take, a, best_a)
        x = x + best_a[:, None] * p
        jar = jar + best_a[:, None] * Jp
        g_new = grad(x, jar)
        Mg_new = _mv(Minv, g_new)
        num = dot(g_new, Mg_new - Mg)
        den = torch.clamp(dot(g, Mg), min=1e-12)
        beta = torch.clamp(num / den, min=0.0)
        p = -Mg_new + beta[:, None] * p
        g, Mg = g_new, Mg_new
    return x, -force(jar)


def fused_core_inputs(m: Model, d: Data, qfrc_smooth: torch.Tensor):
    """The fused core's static configuration and tensors for this state:
    (kind_s, iterations, nfacet, args, sel, n_s), with `args` as
    `constraint_batched.fused_step_core` takes them after `nfacet`; None
    when the model cannot take this path."""
    if m.opt.solver != "cg":
        return None
    pre = _post_gather_prelude(m, d)
    if pre is None:
        return None
    head, sel, S, nfacet, kind_s, n_s = pre
    damp = m.dof_damping + d.act_vel_damping
    args = (*head, qfrc_smooth, d.qacc, damp, m.opt.timestep)
    return kind_s, int(m.opt.cg_iterations), nfacet, args, sel, n_s


def solve_fused_step(m: Model, d: Data, qfrc_smooth: torch.Tensor):
    """The fused hot-path solve: M^-1, qacc_smooth, warmstart, the CG
    constraint solve and the implicit-damping Euler velocity update.
    Returns (Data with qacc/qacc_smooth/forces, qvel_new), or None when
    the model cannot take this path."""
    from robogym_torch.physics import constraint_batched

    inp = fused_core_inputs(m, d, qfrc_smooth)
    if inp is None:
        return None
    kind_s, iterations, nfacet, args, sel, n_s = inp
    B, S = sel.shape
    x, qfrc, f, qvel_new, qs = constraint_batched.fused_step_core(kind_s, iterations, nfacet,
                                                                  *args)
    block = f[:, n_s:].reshape(B, S, nfacet).sum(dim=-1)
    efc_force_contact = torch.zeros_like(d.contact.dist).scatter(1, sel, block)
    d_out = d.replace(qacc=x, qacc_smooth=qs, qfrc_constraint=qfrc,
                      efc_force_contact=efc_force_contact)
    return d_out, qvel_new
