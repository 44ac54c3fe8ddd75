"""Soft-constraint assembly and the constraint solves.

Counterpart of `robogym_tpu/physics/constraint.py`: MuJoCo's constraint
model (solref/solimp impedances, pyramidal friction cones, weld, connect
and joint equalities, joint and tendon limits, dof friction loss) minimized over qacc by preconditioned nonlinear
CG. Two entry points:

  * `solve_fused_step`, step's hot path: picks the `opt.ncon_active`
    deepest contact slots, gathers their data and hands everything to
    `constraint_batched.fused_step_core` (the two SPD-inverse kernels and
    the fused CG kernel with the Euler update);
  * `solve`, forward()'s and the unfused step's: the same gather into
    `constraint_batched.solve_core` (the CG kernel without the Euler
    update) where the model has contact slots; otherwise `make_efc`
    assembles J, aref and the row weights and `cg_kernel.cg` solves.

The Newton solver is not ported.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from robogym_torch.mjcf.model import Data, Model
from robogym_torch.physics import tables
from robogym_torch.physics.collision import driver as collision_driver
from robogym_torch.physics.smooth import mv
from robogym_torch.physics.tables import on_device
from robogym_torch.utils.rotation import cross

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


def _point_jac_batch(m: Model, d: Data, points: torch.Tensor, bodyids: torch.Tensor):
    """Translational point Jacobians of (B, S) points (B, S, 3) on bodies
    `bodyids` (B, S): (B, S, nv, 3)."""
    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    rootid = on_device(c, "body_rootid", np.asarray(c.body_rootid, np.int64), dev, torch.long)
    rc = _take(d.subtree_com, rootid[bodyids])
    offset = points - rc
    jac = d.cdof[:, None, :, 3:] + cross(d.cdof[:, None, :, :3], offset[:, :, None, :])
    mask = on_device(c, "body_dof_mask", c.body_dof_mask, dev, dtype)[bodyids]   # (B, S, nv)
    return jac * mask[..., None]


def _rot_jac_batch(m: Model, d: Data, bodyids: torch.Tensor):
    """Rotational Jacobians of bodies `bodyids` (B, S): (B, S, nv, 3)."""
    c = m.const
    mask = on_device(c, "body_dof_mask", c.body_dof_mask, d.qpos.device, d.qpos.dtype)[bodyids]
    return d.cdof[:, None, :, :3] * mask[..., None]


def _equality_rows(m: Model, d: Data, body_iw0, dof_iw0):
    """The equality rows, one equality after another in model order: a
    weld's 3 position rows then 3 rotation rows, a connect's 3 rows, a
    joint equality's one row (the polynomial of `joint2` where obj2 > 0).
    Returns the block's (J, pos, solref, solimp, floss, active, kind,
    diagA) as `scalar_blocks` stacks it."""
    from robogym_torch.mjcf.model import EqType
    from robogym_torch.physics import smooth
    from robogym_torch.utils import rotation as rot

    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    B, nv = d.qpos.shape[0], c.nv
    ids = on_device(c, "sb_eq", np.arange(c.neq, dtype=np.int64), dev, torch.long)

    def field(name):
        v = m.take(name, ids)
        return v.expand((B,) + tuple(v.shape[-2:])) if v.dim() == 2 else v

    data, solref, solimp = field("eq_data"), field("eq_solref"), field("eq_solimp")
    active = m.take("eq_active", ids) > 0
    active = active.expand(B, c.neq) if active.dim() == 1 else active

    def xform(body, v):
        return d.xpos[:, body] + torch.einsum("bij,bj->bi", d.xmat[:, body], v)

    J, pos, diagA, eq_of = [], [], [], []
    for e in range(c.neq):
        et, o1, o2 = int(c.eq_type[e]), int(c.eq_obj1id[e]), int(c.eq_obj2id[e])
        if et == EqType.WELD:
            pos_err = d.xpos[:, o2] - xform(o1, data[:, e, 3:6])
            target = rot.quat_mul(d.xquat[:, o1], rot.quat_unit(data[:, e, 6:10]))
            rot_err = 2.0 * rot.quat_mul(d.xquat[:, o2], rot.quat_conjugate(target))[:, 1:]
            p2 = d.xpos[:, o2]
            Jp = smooth.point_jacobian(m, d, p2, o2) - smooth.point_jacobian(m, d, p2, o1)
            Jr = smooth.rotation_jacobian(m, d, o2) - smooth.rotation_jacobian(m, d, o1)
            J += [Jp, Jr]
            pos += [pos_err, rot_err]
            diagA += [body_iw0[o1, 0] + body_iw0[o2, 0]] * 3 + [body_iw0[o1, 1] + body_iw0[o2, 1]] * 3
            eq_of += [e] * 6
        elif et == EqType.CONNECT:
            point = xform(o1, data[:, e, 0:3])
            J.append(smooth.point_jacobian(m, d, point, o1) - smooth.point_jacobian(m, d, point, o2))
            pos.append(point - xform(o2, data[:, e, 3:6]))
            diagA += [body_iw0[o1, 0] + body_iw0[o2, 0]] * 3
            eq_of += [e] * 3
        elif et == EqType.JOINT:
            q1, d1 = int(c.jnt_qposadr[o1]), int(c.jnt_dofadr[o1])
            p = data[:, e]
            row = torch.zeros((B, 1, nv), dtype=dtype, device=dev)
            row[:, 0, d1] = 1.0
            if o2 > 0:
                q2, d2 = int(c.jnt_qposadr[o2]), int(c.jnt_dofadr[o2])
                dq = d.qpos[:, q2]
                poly = p[:, 0] + dq * (p[:, 1] + dq * (p[:, 2] + dq * (p[:, 3] + dq * p[:, 4])))
                dpoly = p[:, 1] + dq * (2 * p[:, 2] + dq * (3 * p[:, 3] + dq * 4 * p[:, 4]))
                row[:, 0, d2] = row[:, 0, d2] - dpoly
                pos.append((d.qpos[:, q1] - poly)[:, None])
                diagA.append(dof_iw0[d1] + dof_iw0[d2])
            else:
                pos.append((d.qpos[:, q1] - p[:, 0])[:, None])
                diagA.append(dof_iw0[d1])
            J.append(row)
            eq_of.append(e)
    rows = on_device(c, "sb_eq_rows", np.asarray(eq_of, np.int64), dev, torch.long)
    n = len(eq_of)
    return (torch.cat(J, dim=1), torch.cat(pos, dim=1), solref[:, rows], solimp[:, rows],
            torch.zeros((B, n), dtype=dtype, device=dev), active[:, rows],
            np.full(n, EQ, np.int32), np.asarray(diagA, np.float64))


def scalar_blocks(m: Model, d: Data):
    """Non-contact constraint rows: equality, dof friction, joint limits,
    tendon limits. Returns (J (B, n, nv), pos (B, n), solref (B, n, 2),
    solimp (B, n, 5), floss (B, n), active (B, n), kind (n,) numpy,
    diagA (n,) numpy)."""
    from robogym_torch.physics.setconst import invweight0

    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    B, nv = d.qpos.shape[0], c.nv
    dof_iw0, body_iw0, ten_iw0 = invweight0(m)

    def ex(t):
        return t.expand((B,) + tuple(t.shape))

    def ix(key, arr):
        return on_device(c, "sb_" + key, np.asarray(arr, np.int64), dev, torch.long)

    blocks = [_equality_rows(m, d, body_iw0, dof_iw0)] if c.neq else []
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
        jr = m.take("jnt_range", jids)
        dist_lo = qv - jr[..., 0]
        dist_hi = jr[..., 1] - qv
        dist = torch.minimum(dist_lo, dist_hi)
        sign = torch.where(dist_lo < dist_hi, torch.ones_like(dist), -torch.ones_like(dist))
        margin = m.take("jnt_margin", jids)       # (n,), or (B, n) per env
        onehot = np.zeros((n, nv), np.float32)
        onehot[np.arange(n), dadr_np] = 1.0
        blocks.append((
            on_device(c, "sb_lim_onehot", onehot, dev, dtype) * sign[..., None],
            dist - margin,
            ex(m.jnt_solref[jids]), ex(m.jnt_solimp[jids]),
            torch.zeros((B, n), dtype=dtype, device=dev),
            dist < margin,
            np.full(n, ONESIDED, np.int32), dof_iw0[dadr_np],
        ))

    lt_np = np.nonzero(np.asarray(c.tendon_limited))[0]
    if len(lt_np):
        lt = ix("ten", lt_np)
        L = d.ten_length[:, lt]
        tr = m.take("tendon_range", lt)
        dist_lo = L - tr[..., 0]
        dist_hi = tr[..., 1] - L
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


def _gather_slots(m: Model, d: Data):
    """The `opt.ncon_active` deepest contact slots (sel (B, S)) and their
    data, gathered: pos, frame (B, S, 3, 3), dist, margin, condim, active,
    body ids b1/b2, the winner's solref/solimp/friction and the contact
    diagApprox iw; nfacet from the slot layout. None when the model has no
    contact slots."""
    c = m.const
    con = d.contact
    ncon = con.dist.shape[1]
    S = min(m.opt.ncon_active, ncon)
    if ncon == 0 or S <= 0:
        return None
    dev = d.qpos.device
    condims = np.asarray(collision_driver.contact_slot_layout(c, m.opt.group_cap), np.int32)
    # the S deepest slots; inactive slots score BIG and ties go to the lower
    # slot index, as lax.top_k does
    score = torch.where(con.active, con.dist - con.includemargin,
                        torch.full_like(con.dist, BIG))
    sel = torch.sort(score, dim=-1, stable=True).indices[:, :S]
    b1 = _take(con.body1, sel).long()
    b2 = _take(con.body2, sel).long()
    wrow = on_device(c, "slot_winner_rows",
                     collision_driver.slot_winner_rows(c, m.opt.group_cap), dev, torch.long)
    wg = _take(con.wtab, wrow[sel])                                    # (B, S, 12)
    from robogym_torch.physics.setconst import invweight0_tensors

    bw_trn = invweight0_tensors(m)[1][:, 0]
    return dict(
        sel=sel, nfacet={1: 1, 3: 4, 4: 6, 6: 10}[int(condims.max())],
        pos=_take(con.pos, sel), frame=collision_driver.contact_frame(_take(con.normal, sel)),
        dist=_take(con.dist, sel), margin=_take(con.includemargin, sel),
        condim=_take(con.condim, sel), active=_take(con.active, sel), b1=b1, b2=b2,
        solref=wg[..., 0:2], solimp=wg[..., 2:7], fric=wg[..., 7:12],
        iw=4.0 / torch.clamp(m.opt.impratio, min=1e-6) * (bw_trn[b1] + bw_trn[b2]),
    )


def _post_gather_prelude(m: Model, d: Data):
    """Contact-slot selection and gather for the post-gather cores. Returns
    None when the model has no contact slots."""
    c = m.const
    g = _gather_slots(m, d)
    if g is None:
        return None
    dev, dtype = d.qpos.device, d.qpos.dtype
    J_s, pos_s, solref_s, solimp_s, floss_s, active_s, kind_s, diagA_s = scalar_blocks(m, d)
    dofmask = on_device(c, "body_dof_mask", c.body_dof_mask, dev, dtype)
    rootcom = d.subtree_com[:, on_device(c, "body_rootid", np.asarray(c.body_rootid, np.int64),
                                         dev, torch.long)]
    b1, b2 = g["b1"], g["b2"]
    head = (
        J_s, pos_s, solref_s, solimp_s, floss_s, active_s.to(dtype),
        torch.as_tensor(diagA_s, dtype=dtype, device=dev),
        g["pos"], g["frame"], g["dist"], g["margin"], g["fric"], g["active"], g["condim"], g["iw"],
        dofmask[b1], dofmask[b2], _take(rootcom, b1), _take(rootcom, b2),
        g["solref"], g["solimp"], d.cdof, d.qvel, d.qM,
    )
    sel = g["sel"]
    return head, sel, sel.shape[1], g["nfacet"], np.asarray(kind_s, np.int32), J_s.shape[1]


def kind_masked_D(kind: np.ndarray, D: torch.Tensor):
    """(Deq, Done, Dfr): D (..., E) masked by the static row kinds."""
    kind = np.asarray(kind, np.int32)
    outs = []
    for want in (EQ, ONESIDED, FRICTION):
        mask = torch.as_tensor(kind == want, device=D.device)
        outs.append(torch.where(mask, D, torch.zeros_like(D)))
    return tuple(outs)


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
    x, qfrc, f, qvel_new, qs = constraint_batched.fused_step_core(kind_s, iterations, nfacet,
                                                                  *args)
    d_out = d.replace(qacc=x, qacc_smooth=qs, qfrc_constraint=qfrc,
                      efc_force_contact=_contact_forces(d, f, sel, n_s, nfacet))
    return d_out, qvel_new


def make_efc(m: Model, d: Data):
    """Assemble the constraint rows: J (B, E, nv), aref, D, floss (B, E),
    the static row kinds, and where the model has contact slots the
    selected slots (B, S). Row layout: [equality | dof friction | joint limits |
    tendon limits | contact facets, contact-major]. Returns None when the
    model has no constraint row."""
    dev, dtype = d.qpos.device, d.qpos.dtype
    B, nv = d.qpos.shape[0], m.const.nv
    J, pos, solref, solimp, floss, active, kind, diagA_s = scalar_blocks(m, d)
    n_s = J.shape[1]
    diagA = torch.as_tensor(diagA_s, dtype=dtype, device=dev).expand(B, n_s)
    g = _gather_slots(m, d)
    if g is None and n_s == 0:
        return None
    sel, nfacet = (None, 0) if g is None else (g["sel"], g["nfacet"])
    if g is not None:
        S, cd = sel.shape[1], g["condim"]
        Jrel = _point_jac_batch(m, d, g["pos"], g["b2"]) - _point_jac_batch(m, d, g["pos"], g["b1"])

        def project(row, J3):
            return torch.einsum("bsi,bsvi->bsv", g["frame"][:, :, row], J3)

        Jn = project(0, Jrel)
        fric = g["fric"]
        facets, facet_ok = [Jn], [cd >= 1]
        if nfacet >= 4:
            Jt1, Jt2 = project(1, Jrel), project(2, Jrel)
            f0, f1 = fric[..., 0:1], fric[..., 1:2]
            facets = [Jn + f0 * Jt1, Jn - f0 * Jt1, Jn + f1 * Jt2, Jn - f1 * Jt2]
            facet_ok = [cd >= 3] * 4
        if nfacet >= 6:
            Jr = _rot_jac_batch(m, d, g["b2"]) - _rot_jac_batch(m, d, g["b1"])
            Jtn = project(0, Jr)
            f2 = fric[..., 2:3]
            facets += [Jn + f2 * Jtn, Jn - f2 * Jtn]
            facet_ok += [cd >= 4] * 2
        if nfacet == 10:
            Jr1, Jr2 = project(1, Jr), project(2, Jr)
            f3, f4 = fric[..., 3:4], fric[..., 4:5]
            facets += [Jn + f3 * Jr1, Jn - f3 * Jr1, Jn + f4 * Jr2, Jn - f4 * Jr2]
            facet_ok += [cd >= 6] * 4
        # condim-1 slots keep only the normal row
        ok = torch.stack(facet_ok, dim=-1) | (torch.arange(nfacet, device=dev) == 0)
        rep = lambda x: torch.repeat_interleave(x, nfacet, dim=1)
        J = torch.cat([J, torch.stack(facets, dim=2).reshape(B, S * nfacet, nv)], dim=1)
        pos = torch.cat([pos, rep(g["dist"] - g["margin"])], dim=1)
        solref = torch.cat([solref, rep(g["solref"])], dim=1)
        solimp = torch.cat([solimp, rep(g["solimp"])], dim=1)
        floss = torch.cat([floss, torch.zeros((B, S * nfacet), dtype=dtype, device=dev)], dim=1)
        active = torch.cat([active, (g["active"][..., None] & ok).reshape(B, S * nfacet)], dim=1)
        kind = np.concatenate([kind, np.full(S * nfacet, ONESIDED, np.int32)])
        diagA = torch.cat([diagA, rep(g["iw"])], dim=1)

    imp = _impedance(solimp, pos)
    k_ref, b_ref = _ref_kb(solref, solimp)
    aref = -b_ref * mv(J, d.qvel) - k_ref * imp * pos
    R = torch.clamp(torch.clamp((1.0 - imp) / imp, min=1e-8) * diagA, min=1e-12)
    D = torch.where(active, 1.0 / R, torch.zeros_like(R))
    return dict(J=J, aref=aref, D=D, floss=floss, kind=np.asarray(kind, np.int32), n_scalar=n_s,
                contact_sel=sel, nfacet=nfacet)


def _warmstart(d: Data) -> torch.Tensor:
    """qacc where every entry of an env's qacc is finite, else
    qacc_smooth: per env, as the JAX package's test runs under vmap."""
    finite = torch.isfinite(d.qacc).all(dim=-1, keepdim=True)
    return torch.where(finite, d.qacc, d.qacc_smooth)


def _contact_forces(d: Data, f: torch.Tensor, sel, n_s: int, nfacet: int) -> torch.Tensor:
    """Normal force per contact slot: the sum of its facet forces, zero in
    the slots not selected."""
    out = torch.zeros_like(d.contact.dist)
    if sel is None:
        return out
    B, S = sel.shape
    return out.scatter(1, sel, f[:, n_s:n_s + S * nfacet].reshape(B, S, nfacet).sum(dim=-1))


def solve(m: Model, d: Data, Minv: torch.Tensor = None) -> Data:
    """The constraint solve for qacc (d.qacc_smooth filled): fills qacc,
    qfrc_constraint and the contact forces. Where the model has contact
    slots, the post-gather CG core without the Euler update; otherwise
    `make_efc` and the CG kernel on its J."""
    if Minv is None:
        from robogym_torch.physics import factor_kernel

        Minv = factor_kernel.spd_inverse(d.qM)
    if m.opt.solver == "cg":
        out = _solve_cg_post_gather(m, d, Minv)
        if out is not None:
            return out
    efc = make_efc(m, d)
    if efc is None:
        return d.replace(qacc=d.qacc_smooth, qfrc_constraint=torch.zeros_like(d.qacc_smooth))
    if m.opt.solver != "cg":
        raise NotImplementedError(
            "constraint.solve: the Newton solver branch is not ported; only the CG solver "
            f"(the default) is, and this model sets solver={m.opt.solver!r}")
    return _solve_cg(m, d, efc, Minv)


def _solve_cg_post_gather(m: Model, d: Data, Minv: torch.Tensor):
    """The CG solve through `constraint_batched.solve_core`: contact slots
    selected and gathered here, the rows built and solved by the kernel.
    Returns None when the model has no contact slots."""
    from robogym_torch.physics import constraint_batched

    pre = _post_gather_prelude(m, d)
    if pre is None:
        return None
    head, sel, _, nfacet, kind_s, n_s = pre
    x, qfrc, f = constraint_batched.solve_core(kind_s, int(m.opt.cg_iterations), nfacet, *head,
                                               Minv, d.qacc_smooth, _warmstart(d))
    return d.replace(qacc=x, qfrc_constraint=qfrc,
                     efc_force_contact=_contact_forces(d, f, sel, n_s, nfacet))


def _solve_cg(m: Model, d: Data, efc, Minv: torch.Tensor) -> Data:
    """Preconditioned nonlinear CG on `make_efc`'s rows, warmstarted from
    the previous qacc, through the CG kernel (`cg_kernel.cg`)."""
    from robogym_torch.physics import cg_kernel

    J = efc["J"].contiguous()
    Deq, Done, Dfr = kind_masked_D(efc["kind"], efc["D"])
    x, f = cg_kernel.cg(J, efc["aref"], Deq, Done, Dfr, efc["floss"], d.qM.contiguous(),
                        Minv.contiguous(), d.qacc_smooth, _warmstart(d),
                        int(m.opt.cg_iterations))
    return d.replace(qacc=x, qfrc_constraint=mv(J.transpose(-1, -2), f),
                     efc_force_contact=_contact_forces(d, f, efc["contact_sel"],
                                                       efc["n_scalar"], efc["nfacet"]))
