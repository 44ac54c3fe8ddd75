"""Smooth (unconstrained) dynamics: kinematics, CoM quantities, CRB mass
matrix, RNE bias forces, tendons, transmission and passive forces.

Counterpart of `robogym_tpu/physics/smooth.py`, written batched: every
`Data` tensor carries a leading env axis `(B, ...)` and the shared `Model`
broadcasts against it. Tree recursions are masked matmuls against the
static tables of `physics/tables.py`; forward kinematics takes one batched
step per tree level. Spatial algebra is Plücker (angular, linear), as in
MuJoCo's com-based cdof/cvel/cinert.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from robogym_torch.mjcf.model import Data, JointType, Model, WrapType
from robogym_torch.physics import tables
from robogym_torch.physics.tables import on_device
from robogym_torch.utils import rotation as rot


def _ix(c, key, arr, device):
    return on_device(c, key, np.asarray(arr, np.int64), device, torch.long)


def _cross_comps(a, b):
    return [
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ]


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x m, (ang, lin) ordering."""
    va = [v[..., i] for i in range(3)]
    vl = [v[..., 3 + i] for i in range(3)]
    ma = [m[..., i] for i in range(3)]
    ml = [m[..., 3 + i] for i in range(3)]
    ang = _cross_comps(va, ma)
    lin1 = _cross_comps(va, ml)
    lin2 = _cross_comps(vl, ma)
    return torch.stack(ang + [lin1[i] + lin2[i] for i in range(3)], dim=-1)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f, (torque, force) ordering."""
    va = [v[..., i] for i in range(3)]
    vl = [v[..., 3 + i] for i in range(3)]
    n = [f[..., i] for i in range(3)]
    fo = [f[..., 3 + i] for i in range(3)]
    t1 = _cross_comps(va, n)
    t2 = _cross_comps(vl, fo)
    force = _cross_comps(va, fo)
    return torch.stack([t1[i] + t2[i] for i in range(3)] + force, dim=-1)


def mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(..., n, k) x (..., k) -> (..., n)."""
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


# ---------------------------------------------------------------------------
# Kinematics (mj_kinematics) — one batched step per tree level
# ---------------------------------------------------------------------------


def kinematics(m: Model, d: Data) -> Data:
    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    B = d.qpos.shape[0]
    levels = tables.fk_levels(c)

    xpos = torch.zeros((B, c.nbody, 3), dtype=dtype, device=dev)
    xquat = torch.zeros((B, c.nbody, 4), dtype=dtype, device=dev)
    xquat[..., 0] = 1.0

    for li, lvl in enumerate(levels):
        bids = _ix(c, f"fk{li}_b", lvl.bids, dev)
        pids = _ix(c, f"fk{li}_p", lvl.pids, dev)
        pq = xquat[:, pids]
        xq = rot.quat_mul(pq, m.body_quat[bids])
        xp = xpos[:, pids] + rot.quat_rot_vec(pq, m.take("body_pos", bids))

        for si, per_type in enumerate(lvl.slots):
            for jt, (rows_np, jids_np) in per_type.items():
                key = f"fk{li}_{si}_{jt}"
                rows = _ix(c, key + "r", rows_np, dev)
                jids = _ix(c, key + "j", jids_np, dev)
                qadr_np = c.jnt_qposadr[jids_np]
                sub_q = xq[:, rows]
                sub_p = xp[:, rows]
                if jt == JointType.FREE:
                    new_p = d.qpos[:, _ix(c, key + "q3", qadr_np[:, None] + np.arange(3), dev)]
                    new_q = rot.quat_unit(
                        d.qpos[:, _ix(c, key + "q4", qadr_np[:, None] + 3 + np.arange(4), dev)]
                    )
                elif jt == JointType.BALL:
                    jpos = m.jnt_pos[jids]
                    anchor = sub_p + rot.quat_rot_vec(sub_q, jpos)
                    qloc = rot.quat_unit(
                        d.qpos[:, _ix(c, key + "q4", qadr_np[:, None] + np.arange(4), dev)]
                    )
                    new_q = rot.quat_mul(sub_q, qloc)
                    new_p = anchor - rot.quat_rot_vec(new_q, jpos)
                elif jt == JointType.SLIDE:
                    qadr = _ix(c, key + "q", qadr_np, dev)
                    axis_w = rot.quat_rot_vec(sub_q, m.jnt_axis[jids])
                    new_p = sub_p + axis_w * (d.qpos[:, qadr] - m.qpos0[qadr])[..., None]
                    new_q = sub_q
                else:  # HINGE
                    qadr = _ix(c, key + "q", qadr_np, dev)
                    jpos = m.jnt_pos[jids]
                    anchor = sub_p + rot.quat_rot_vec(sub_q, jpos)
                    angle = d.qpos[:, qadr] - m.qpos0[qadr]
                    qloc = rot.quat_from_angle_and_axis(angle, m.jnt_axis[jids])
                    new_q = rot.quat_mul(sub_q, qloc)
                    new_p = anchor - rot.quat_rot_vec(new_q, jpos)
                xq = xq.clone()
                xp = xp.clone()
                xq[:, rows] = new_q
                xp[:, rows] = new_p

        if len(lvl.mocap_rows):
            mrows = _ix(c, f"fk{li}_mr", lvl.mocap_rows, dev)
            mids = _ix(c, f"fk{li}_mi", lvl.mocap_ids, dev)
            xp[:, mrows] = d.mocap_pos[:, mids]
            xq[:, mrows] = rot.quat_unit(d.mocap_quat[:, mids])

        xpos[:, bids] = xp
        xquat[:, bids] = xq

    xmat = rot.quat2mat(xquat)
    ispec = "xbij,xbj->xbi" if m.per_env("body_ipos") else "xbij,bj->xbi"
    xipos = xpos + torch.einsum(ispec, xmat, m.body_ipos)
    ximat = torch.matmul(xmat, rot.quat2mat(m.body_iquat))
    gb = _ix(c, "geom_bodyid", c.geom_bodyid, dev)
    geom_xmat = torch.matmul(xmat[:, gb], rot.quat2mat(m.geom_quat))
    gspec = "xgij,xgj->xgi" if m.per_env("geom_pos") else "xgij,gj->xgi"
    geom_xpos = xpos[:, gb] + torch.einsum(gspec, xmat[:, gb], m.geom_pos)
    if c.nsite:
        sb = _ix(c, "site_bodyid", c.site_bodyid, dev)
        site_xmat = torch.matmul(xmat[:, sb], rot.quat2mat(m.site_quat))
        spec = "xgij,xgj->xgi" if m.per_env("site_pos") else "xgij,gj->xgi"
        site_xpos = xpos[:, sb] + torch.einsum(spec, xmat[:, sb], m.site_pos)
    else:
        site_xpos, site_xmat = d.site_xpos, d.site_xmat

    return d.replace(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
        geom_xpos=geom_xpos, geom_xmat=geom_xmat,
        site_xpos=site_xpos, site_xmat=site_xmat,
    )


def _joint_anchors_axes(m: Model, d: Data) -> Tuple[torch.Tensor, torch.Tensor]:
    c = m.const
    bid = _ix(c, "jnt_bodyid", c.jnt_bodyid, d.qpos.device)
    xm = d.xmat[:, bid]
    anchors = d.xpos[:, bid] + torch.einsum("xjik,jk->xji", xm, m.jnt_pos)
    axes = torch.einsum("xjik,jk->xji", xm, m.jnt_axis)
    return anchors, axes


# ---------------------------------------------------------------------------
# CoM-based quantities (mj_comPos)
# ---------------------------------------------------------------------------


def com_pos(m: Model, d: Data) -> Data:
    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    S = on_device(c, "subtree_mask", tables.body_subtree_mask(c), dev, dtype)

    mass = m.body_mass                                               # (nbody,) or (B, nbody)
    msum = S @ mass if mass.dim() == 1 else mass @ S.T               # subtree masses
    mpos = torch.einsum("ij,xjk->xik", S, mass[..., None] * d.xipos)  # (B, nbody, 3)
    subtree_com = mpos / torch.clamp(msum, min=1e-12)[..., None]
    subtree_com = torch.where((msum < 1e-12)[..., None], d.xpos, subtree_com)

    root_com = subtree_com[:, _ix(c, "body_rootid", c.body_rootid, dev)]

    R = [[d.ximat[..., i, j] for j in range(3)] for i in range(3)]
    Iv = [m.body_inertia[..., j] for j in range(3)]
    Ic = [[R[i][0] * Iv[0] * R[k][0] + R[i][1] * Iv[1] * R[k][1] + R[i][2] * Iv[2] * R[k][2]
           for k in range(3)] for i in range(3)]
    cvec = d.xipos - root_com
    cx = [cvec[..., 0], cvec[..., 1], cvec[..., 2]]
    z = torch.zeros_like(cx[0])
    sk = [[z, -cx[2], cx[1]], [cx[2], z, -cx[0]], [-cx[1], cx[0], z]]
    mS = [[mass * sk[i][j] for j in range(3)] for i in range(3)]
    tl = [[Ic[i][k] + (mS[i][0] * sk[k][0] + mS[i][1] * sk[k][1] + mS[i][2] * sk[k][2])
           for k in range(3)] for i in range(3)]
    massb = mass.expand_as(z)
    mI = [[massb if i == k else z for k in range(3)] for i in range(3)]
    comps = []
    for i in range(3):
        comps += tl[i] + mS[i]
    for i in range(3):
        comps += [mS[k][i] for k in range(3)] + mI[i]
    cinert66 = torch.stack(comps, dim=-1).reshape(d.qpos.shape[0], c.nbody, 6, 6)

    anchors, axes = _joint_anchors_axes(m, d)
    dtab = tables.dof_tables(c)
    if c.nv:
        bidv = _ix(c, "dof_bid", dtab["bid"], dev)
        jidv = _ix(c, "dof_jid", dtab["jid"], dev)
        onehot = on_device(c, "dof_kcol_onehot", np.eye(3, dtype=np.float32)[dtab["kcol"]], dev, dtype)
        offset = root_com[:, bidv] - anchors[:, jidv]
        ax_col = torch.einsum("xvij,vj->xvi", d.xmat[:, bidv], onehot)
        axes_j = axes[:, jidv]

        def flag(name):
            return on_device(c, "dof_" + name, dtab[name], dev)[:, None]

        zero = torch.zeros_like(ax_col)
        ang = torch.where(flag("is_rot_col"), ax_col,
                          torch.where(flag("is_hinge"), axes_j, zero))
        lin_cross = rot.cross(ang, offset)
        lin = torch.where(flag("is_free_lin"), onehot.expand_as(ang),
                          torch.where(flag("is_slide"), axes_j, lin_cross))
        cdof = torch.cat([ang, lin], dim=-1)
    else:
        cdof = torch.zeros((d.qpos.shape[0], 0, 6), dtype=dtype, device=dev)

    return d.replace(subtree_com=subtree_com, cdof=cdof, cinert=cinert66)


def crb(m: Model, d: Data) -> Data:
    """Dense joint-space mass matrix via composite-rigid-body inertias."""
    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    B = d.qpos.shape[0]
    S = on_device(c, "subtree_mask", tables.body_subtree_mask(c), dev, dtype)
    IC36 = torch.einsum("ij,xjk->xik", S, d.cinert.reshape(B, c.nbody, 36))
    ICd = IC36[:, _ix(c, "dof_bid", tables.dof_tables(c)["bid"], dev)]   # (B, nv, 36)
    cd = [d.cdof[..., j] for j in range(6)]
    F = torch.stack(
        [sum(ICd[..., 6 * i + j] * cd[j] for j in range(6)) for i in range(6)], dim=-1
    )
    qMu = torch.matmul(d.cdof, F.transpose(-1, -2))
    A = on_device(c, "anc_upper", tables.dof_ancestor_or_self_upper(c), dev, dtype)
    qMm = qMu * A
    qM = qMm + qMm.transpose(-1, -2) - torch.diag_embed(torch.diagonal(qMm, dim1=-2, dim2=-1))
    qM = qM + torch.diag(m.dof_armature)
    return d.replace(qM=qM)


# ---------------------------------------------------------------------------
# Velocity pass + RNE (mj_comVel / mj_rne)
# ---------------------------------------------------------------------------


def com_vel(m: Model, d: Data) -> Tuple[Data, torch.Tensor]:
    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    if c.nv == 0:
        B = d.qpos.shape[0]
        return (d.replace(cvel=torch.zeros((B, c.nbody, 6), dtype=dtype, device=dev)),
                torch.zeros((B, 0, 6), dtype=dtype, device=dev))
    vterm = d.cdof * d.qvel[..., None]                              # (B, nv, 6)
    mask = on_device(c, "body_dof_mask", c.body_dof_mask, dev, dtype)
    cvel = torch.einsum("bv,xvk->xbk", mask, vterm)
    D = on_device(c, "dof_anc", tables.dof_ancestor_mask(c), dev, dtype)
    vpred = torch.einsum("iv,xvk->xik", D, vterm)
    cdofdot = motion_cross(vpred, d.cdof)
    return d.replace(cvel=cvel), cdofdot


def rne(m: Model, d: Data, cdofdot: torch.Tensor) -> Data:
    """qfrc_bias = C(qpos, qvel): RNE with qacc = 0, gravity at the root."""
    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    g = m.opt.gravity
    grav = torch.cat([torch.zeros_like(g), -g], dim=-1)
    grav = grav[:, None] if m.per_env("opt:gravity") else grav
    mask = on_device(c, "body_dof_mask", c.body_dof_mask, dev, dtype)
    cacc = grav + torch.einsum("bv,xvk->xbk", mask, cdofdot * d.qvel[..., None])
    cin = [[d.cinert[..., i, j] for j in range(6)] for i in range(6)]

    def apply_I(x):
        return torch.stack(
            [sum(cin[i][j] * x[..., j] for j in range(6)) for i in range(6)], dim=-1
        )

    Iv = apply_I(d.cvel)
    f = apply_I(cacc) + force_cross(d.cvel, Iv)
    dots = torch.einsum("xvi,xbi->xbv", d.cdof, f)
    qfrc_bias = torch.sum(mask * dots, dim=1)
    return d.replace(qfrc_bias=qfrc_bias)


# ---------------------------------------------------------------------------
# Point Jacobians (mj_jac)
# ---------------------------------------------------------------------------


def point_jacobian(m: Model, d: Data, point: torch.Tensor, bodyid: int) -> torch.Tensor:
    """Translational Jacobian (B, 3, nv) of world points (B, 3) on a body."""
    c = m.const
    rc = d.subtree_com[:, int(c.body_rootid[bodyid])]
    offset = point - rc
    jac = d.cdof[..., 3:] + rot.cross(d.cdof[..., :3], offset[:, None, :])
    mask = on_device(c, "body_dof_mask", c.body_dof_mask, d.qpos.device, d.qpos.dtype)[bodyid]
    return (jac * mask[:, None]).transpose(-1, -2)


def rotation_jacobian(m: Model, d: Data, bodyid: int) -> torch.Tensor:
    """Rotational Jacobian (B, 3, nv) of a body."""
    c = m.const
    mask = on_device(c, "body_dof_mask", c.body_dof_mask, d.qpos.device, d.qpos.dtype)[bodyid]
    return (d.cdof[..., :3] * mask[:, None]).transpose(-1, -2)


# ---------------------------------------------------------------------------
# Tendons (mj_tendon): fixed (joint-coef) and spatial (site/wrap)
# ---------------------------------------------------------------------------


def tendon(m: Model, d: Data) -> Data:
    c = m.const
    if c.ntendon == 0:
        return d
    dev, dtype = d.qpos.device, d.qpos.dtype
    B = d.qpos.shape[0]
    tt = tables.tendon_tables(c)

    ten_length = torch.zeros((B, c.ntendon), dtype=dtype, device=dev)
    ten_J = torch.zeros((B, c.ntendon, c.nv), dtype=dtype, device=dev)

    if len(tt["w_t"]):
        w_t = _ix(c, "ten_w_t", tt["w_t"], dev)
        coef = m.wrap_prm[_ix(c, "ten_w_i", tt["w_i"], dev)]
        ten_length = ten_length.index_add(1, w_t, coef * d.qpos[:, _ix(c, "ten_w_q", tt["w_q"], dev)])
        Jfix = torch.zeros((c.ntendon, c.nv), dtype=dtype, device=dev)
        Jfix = Jfix.index_put((w_t, _ix(c, "ten_w_d", tt["w_d"], dev)), coef, accumulate=True)
        ten_J = ten_J + Jfix

    for t in tt["spatial"]:
        adr, num = int(c.tendon_adr[t]), int(c.tendon_num[t])
        L, J = _spatial_tendon(m, d, adr, num)
        ten_length = ten_length.clone()
        ten_J = ten_J.clone()
        ten_length[:, t] = L
        ten_J[:, t] = J

    ten_velocity = mv(ten_J, d.qvel)
    return d.replace(ten_length=ten_length, ten_J=ten_J, ten_velocity=ten_velocity)


def _spatial_tendon(m: Model, d: Data, adr: int, num: int):
    """Spatial tendon length (B,) and jacobian (B, nv): straight segments
    between sites with sphere-wrap geoms in between."""
    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    B = d.qpos.shape[0]
    entries = []
    for i in range(adr, adr + num):
        wt = int(c.wrap_type[i])
        oid = int(c.wrap_objid[i])
        if wt == WrapType.SITE:
            entries.append(("site", oid, None))
        elif wt == WrapType.SPHERE:
            entries.append(("sphere", oid, None))
        elif wt == WrapType.PULLEY:
            entries.append(("pulley", -1, float(m.wrap_prm[i])))

    L = torch.zeros(B, dtype=dtype, device=dev)
    J = torch.zeros((B, c.nv), dtype=dtype, device=dev)
    divisor = 1.0

    def along(u, Jd):  # (B, 3), (B, 3, nv) -> (B, nv)
        return torch.einsum("xi,xiv->xv", u, Jd)

    idx = 0
    n = len(entries)
    while idx < n:
        kind, oid, prm = entries[idx]
        if kind == "pulley":
            divisor = prm if prm and prm > 0 else 1.0
            idx += 1
            continue
        if kind == "site":
            if idx + 1 < n and entries[idx + 1][0] == "sphere" and idx + 2 < n:
                s_oid = entries[idx + 1][1]
                nxt_oid = entries[idx + 2][1]
                p0 = d.site_xpos[:, oid]
                b0 = int(c.site_bodyid[oid])
                p1 = d.site_xpos[:, nxt_oid]
                b1 = int(c.site_bodyid[nxt_oid])
                gc = d.geom_xpos[:, s_oid]
                gb = int(c.geom_bodyid[s_oid])
                r = m.geom_size[..., s_oid, 0]
                t0, t1, arc, wrapping = _sphere_wrap(p0, p1, gc, r)
                scale = 1.0 / divisor
                dvec_direct = p1 - p0
                dist_direct = rot.norm(dvec_direct, keepdim=True) + 1e-12
                u_dir = dvec_direct / dist_direct
                J0 = point_jacobian(m, d, p0, b0)
                J1 = point_jacobian(m, d, p1, b1)
                Jg0 = point_jacobian(m, d, t0, gb)
                Jg1 = point_jacobian(m, d, t1, gb)
                d0 = rot.norm(t0 - p0, keepdim=True) + 1e-12
                d1 = rot.norm(p1 - t1, keepdim=True) + 1e-12
                u0 = (t0 - p0) / d0
                u1 = (p1 - t1) / d1
                L_wrap = d0[:, 0] + arc + d1[:, 0]
                J_wrap = along(u0, Jg0 - J0) + along(u1, J1 - Jg1)
                L_direct = dist_direct[:, 0]
                J_direct = along(u_dir, J1 - J0)
                L = L + scale * torch.where(wrapping, L_wrap, L_direct)
                J = J + scale * torch.where(wrapping[:, None], J_wrap, J_direct)
                idx += 2
                continue
            elif idx + 1 < n and entries[idx + 1][0] == "site":
                nxt_oid = entries[idx + 1][1]
                p0 = d.site_xpos[:, oid]
                p1 = d.site_xpos[:, nxt_oid]
                dvec = p1 - p0
                dist = rot.norm(dvec, keepdim=True) + 1e-12
                u = dvec / dist
                J0 = point_jacobian(m, d, p0, int(c.site_bodyid[oid]))
                J1 = point_jacobian(m, d, p1, int(c.site_bodyid[nxt_oid]))
                scale = 1.0 / divisor
                L = L + dist[:, 0] * scale
                J = J + scale * along(u, J1 - J0)
        idx += 1
    return L, J


def _sphere_wrap(p0, p1, center, r):
    """2D sphere wrap in the plane of p0, p1 and the center (batched (B, 3)):
    tangent points, arc length and whether the tendon wraps."""
    a = p0 - center
    b = p1 - center
    la = rot.norm(a) + 1e-12
    lb = rot.norm(b) + 1e-12
    ab = p1 - p0
    tproj = torch.clamp(torch.sum((center - p0) * ab, -1) / (torch.sum(ab * ab, -1) + 1e-12), 0.0, 1.0)
    closest = p0 + tproj[:, None] * ab
    dseg = rot.norm(closest - center)
    wrapping = (dseg < r) & (la > r) & (lb > r)

    ex = a / la[:, None]
    bdx = torch.sum(b * ex, -1)
    bperp = b - bdx[:, None] * ex
    ey = bperp / (rot.norm(bperp, keepdim=True) + 1e-12)
    a2 = torch.stack([la, torch.zeros_like(la)], -1)
    b2 = torch.stack([bdx, torch.sum(b * ey, -1)], -1)

    def tangent(p2, sgn):
        dp = rot.norm(p2) + 1e-12
        cosq = torch.clamp(r / dp, 0.0, 1.0)
        alpha = torch.atan2(p2[:, 1], p2[:, 0])
        beta = torch.arccos(cosq)
        ang = alpha + sgn * beta
        return torch.stack([r * torch.cos(ang), r * torch.sin(ang)], -1)

    side = torch.sign(a2[:, 0] * b2[:, 1] - a2[:, 1] * b2[:, 0])
    side = torch.where(side == 0, torch.ones_like(side), side)
    t0_2 = tangent(a2, side)
    t1_2 = tangent(b2, -side)
    ang0 = torch.atan2(t0_2[:, 1], t0_2[:, 0])
    ang1 = torch.atan2(t1_2[:, 1], t1_2[:, 0])
    dang = torch.abs(
        torch.remainder(torch.where(side > 0, ang1 - ang0, ang0 - ang1) + np.pi, 2 * np.pi) - np.pi
    )
    arc = r * dang
    t0 = center + t0_2[:, :1] * ex + t0_2[:, 1:] * ey
    t1 = center + t1_2[:, :1] * ex + t1_2[:, 1:] * ey
    return t0, t1, arc, wrapping


# ---------------------------------------------------------------------------
# Transmission (mj_transmission)
# ---------------------------------------------------------------------------


def transmission(m: Model, d: Data) -> Tuple[Data, torch.Tensor]:
    """actuator_length and the moment matrix (B, nu, nv)."""
    c = m.const
    dev, dtype = d.qpos.device, d.qpos.dtype
    B = d.qpos.shape[0]
    if c.nu == 0:
        return d, torch.zeros((B, 0, c.nv), dtype=dtype, device=dev)
    tr = tables.transmission_tables(c)
    gear = m.actuator_gear[:, 0]
    lengths = torch.zeros((B, c.nu), dtype=dtype, device=dev)
    moment = torch.zeros((B, c.nu, c.nv), dtype=dtype, device=dev)
    if len(tr["uj"]):
        uj = _ix(c, "tr_uj", tr["uj"], dev)
        gj = gear[uj]
        lengths[:, uj] = gj * d.qpos[:, _ix(c, "tr_uj_q", tr["uj_q"], dev)]
        moment[:, uj] = gj[:, None] * on_device(c, "tr_onehot", tr["onehot"], dev, dtype)
    if len(tr["ut"]):
        ut = _ix(c, "tr_ut", tr["ut"], dev)
        ut_t = _ix(c, "tr_ut_t", tr["ut_t"], dev)
        gt = gear[ut]
        lengths[:, ut] = gt * d.ten_length[:, ut_t]
        moment[:, ut] = gt[:, None] * d.ten_J[:, ut_t]
    d = d.replace(actuator_length=lengths, actuator_velocity=mv(moment, d.qvel))
    return d, moment


# ---------------------------------------------------------------------------
# Passive forces (mj_passive)
# ---------------------------------------------------------------------------


def passive(m: Model, d: Data) -> Data:
    c = m.const
    dev = d.qpos.device
    qfrc = -m.dof_damping * d.qvel
    st = tables.scalar_joint_tables(c)
    if len(st["jid"]):
        jids = _ix(c, "sc_jid", st["jid"], dev)
        f = -m.jnt_stiffness[jids] * (d.qpos[:, _ix(c, "sc_qadr", st["qadr"], dev)]
                                      - m.jnt_springref[jids])
        qfrc = qfrc.index_add(1, _ix(c, "sc_dadr", st["dadr"], dev), f)
    if c.ntendon:
        spring_active = m.tendon_lengthspring >= 0
        stretch = d.ten_length - m.tendon_lengthspring
        f_spring = torch.where(spring_active, -m.tendon_stiffness * stretch,
                               torch.zeros_like(stretch))
        f_damp = -m.tendon_damping * d.ten_velocity
        qfrc = qfrc + torch.einsum("xt,xtv->xv", f_spring + f_damp, d.ten_J)
    return d.replace(qfrc_passive=qfrc)
