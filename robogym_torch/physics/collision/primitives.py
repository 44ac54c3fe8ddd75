"""Analytic narrowphase collision functions (plane/sphere/capsule/box).

Counterpart of `robogym_tpu/physics/collision/primitives.py`. Every
function takes per-side (pos (..., 3), rotation (..., 3, 3), size (..., 3))
with any leading batch shape and returns fixed-size contact candidates:

    dist   (..., n)     signed distance (negative = penetrating)
    pos    (..., n, 3)  contact midpoint
    normal (..., n, 3)  unit normal, from geom1 into geom2
"""

from __future__ import annotations

import torch

from robogym_torch.utils.rotation import cross

BIG = 1e10


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _col(xm, j):
    return xm[..., :, j]


def _rot(xm, v):
    """xm @ v for (..., 3, 3) and (..., 3)."""
    return torch.matmul(xm, v.unsqueeze(-1)).squeeze(-1)


def _rot_t(xm, v):
    """xm.T @ v."""
    return torch.matmul(xm.transpose(-1, -2), v.unsqueeze(-1)).squeeze(-1)


def _signs(like):
    return torch.tensor(
        [[sx, sy, sz] for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)],
        dtype=like.dtype, device=like.device,
    )


def _tile(n, k):
    return n.unsqueeze(-2).expand(n.shape[:-1] + (k, 3))


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


# --- plane functions (plane normal is +z of the plane's rotation) -----------


def plane_sphere(xp1, xm1, s1, xp2, xm2, s2):
    n = _col(xm1, 2)
    r = s2[..., 0]
    dist = _dot(xp2 - xp1, n) - r
    pos = xp2 - n * (r + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def plane_capsule(xp1, xm1, s1, xp2, xm2, s2):
    n = _col(xm1, 2)
    r, hh = s2[..., 0], s2[..., 1]
    axis = _col(xm2, 2)
    ends = torch.stack([xp2 + axis * hh[..., None], xp2 - axis * hh[..., None]], dim=-2)
    dist = _dot(ends - xp1[..., None, :], n[..., None, :]) - r[..., None]
    pos = ends - n[..., None, :] * (r[..., None] + 0.5 * dist)[..., None]
    return dist, pos, _tile(n, 2)


def _box_corners(xp, xm, s):
    """(..., 8, 3) world-frame corners."""
    local = _signs(xp) * s[..., None, :]
    return xp[..., None, :] + torch.matmul(local, xm.transpose(-1, -2))


def plane_box(xp1, xm1, s1, xp2, xm2, s2):
    """All 8 corners as slots (at most 4 can touch a plane)."""
    n = _col(xm1, 2)
    corners = _box_corners(xp2, xm2, s2)
    dist = _dot(corners - xp1[..., None, :], n[..., None, :])
    pos = corners - 0.5 * dist[..., None] * n[..., None, :]
    return dist, pos, _tile(n, 8)


def plane_convex(xp1, xm1, s1, xp2, xm2, verts, mask):
    """Plane vs convex hull (verts (..., V, 3)): 4 deepest vertices."""
    n = _col(xm1, 2)
    world = xp2[..., None, :] + torch.matmul(verts, xm2.transpose(-1, -2))
    dist = _dot(world - xp1[..., None, :], n[..., None, :])
    dist = torch.where(mask > 0, dist, torch.full_like(dist, BIG))
    idx = torch.argsort(dist, dim=-1, stable=True)[..., :4]
    dist4 = torch.gather(dist, -1, idx)
    pos4 = torch.gather(world, -2, idx[..., None].expand(idx.shape + (3,)))
    pos4 = pos4 - 0.5 * dist4[..., None] * n[..., None, :]
    return dist4, pos4, _tile(n, 4)


# --- sphere functions --------------------------------------------------------


def sphere_sphere(xp1, xm1, s1, xp2, xm2, s2):
    r1, r2 = s1[..., 0], s2[..., 0]
    dvec = xp2 - xp1
    dist_c = _norm(dvec) + 1e-12
    n = dvec / dist_c[..., None]
    dist = dist_c - r1 - r2
    pos = xp1 + n * (r1 + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _closest_on_segment(p, a, b):
    ab = b - a
    t = torch.clamp(_dot(p - a, ab) / (_dot(ab, ab) + 1e-12), 0.0, 1.0)
    return a + t[..., None] * ab


def sphere_capsule(xp1, xm1, s1, xp2, xm2, s2):
    r1 = s1[..., 0]
    r2, hh = s2[..., 0], s2[..., 1]
    axis = _col(xm2, 2)
    closest = _closest_on_segment(xp1, xp2 - axis * hh[..., None], xp2 + axis * hh[..., None])
    dvec = closest - xp1
    dist_c = _norm(dvec) + 1e-12
    n = dvec / dist_c[..., None]
    dist = dist_c - r1 - r2
    pos = xp1 + n * (r1 + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _sphere_point_box(p, r, xp2, xm2, s2):
    """Sphere (center p, radius r) against a box: (dist, pos, normal)."""
    local = _rot_t(xm2, p - xp2)
    clamped = _clip(local, -s2, s2)
    inside = torch.all(torch.abs(local) < s2, dim=-1)
    face_dist = s2 - torch.abs(local)
    k = torch.argmin(face_dist, dim=-1, keepdim=True)
    push = clamped.scatter(-1, k, torch.gather(torch.sign(local) * s2, -1, k))
    closest_local = torch.where(inside[..., None], push, clamped)
    closest = xp2 + _rot(xm2, closest_local)
    dvec = closest - p
    dn = _norm(dvec) + 1e-12
    n = torch.where(inside[..., None], -dvec / dn[..., None], dvec / dn[..., None])
    dist = torch.where(inside, -(dn + r), dn - r)
    pos = p + n * (r + 0.5 * dist)[..., None]
    return dist, pos, n


def sphere_box(xp1, xm1, s1, xp2, xm2, s2):
    dist, pos, n = _sphere_point_box(xp1, s1[..., 0], xp2, xm2, s2)
    return dist[..., None], pos[..., None, :], n[..., None, :]


def _closest_segment_segment(a0, a1, b0, b1):
    d1 = a1 - a0
    d2 = b1 - b0
    r = a0 - b0
    a = _dot(d1, d1) + 1e-12
    e = _dot(d2, d2) + 1e-12
    f = _dot(d2, r)
    c = _dot(d1, r)
    b = _dot(d1, d2)
    denom = a * e - b * b
    s = torch.where(torch.abs(denom) > 1e-12,
                    torch.clamp((b * f - c * e) / denom, 0.0, 1.0), torch.zeros_like(denom))
    t = (b * s + f) / e
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.clamp((b * t_cl - c) / a, 0.0, 1.0)
    return a0 + d1 * s[..., None], b0 + d2 * t_cl[..., None]


def capsule_capsule(xp1, xm1, s1, xp2, xm2, s2):
    r1, h1 = s1[..., 0], s1[..., 1]
    r2, h2 = s2[..., 0], s2[..., 1]
    ax1, ax2 = _col(xm1, 2), _col(xm2, 2)
    pa, pb = _closest_segment_segment(
        xp1 - ax1 * h1[..., None], xp1 + ax1 * h1[..., None],
        xp2 - ax2 * h2[..., None], xp2 + ax2 * h2[..., None],
    )
    dvec = pb - pa
    dn = _norm(dvec) + 1e-12
    n = dvec / dn[..., None]
    dist = dn - r1 - r2
    pos = pa + n * (r1 + 0.5 * dist)[..., None]
    return dist[..., None], pos[..., None, :], n[..., None, :]


# --- box functions -------------------------------------------------------------


def capsule_box(xp1, xm1, s1, xp2, xm2, s2):
    """Capsule (geom1) vs box (geom2): the 2 deepest of the two endpoint
    spheres and the point nearest the box center."""
    r, hh = s1[..., 0], s1[..., 1]
    axis = _col(xm1, 2)
    e0 = xp1 - axis * hh[..., None]
    e1 = xp1 + axis * hh[..., None]
    tmid = torch.clamp(_dot(xp2 - e0, axis) / (2 * hh + 1e-12), 0.0, 1.0)
    mid = e0 + (e1 - e0) * tmid[..., None]
    cands = torch.stack([e0, e1, mid], dim=-2)                          # (..., 3, 3)
    ex = lambda x: x[..., None, :].expand(cands.shape[:-1] + x.shape[-1:])
    dist, pos, nrm = _sphere_point_box(
        cands, r[..., None], ex(xp2),
        xm2[..., None, :, :].expand(cands.shape[:-1] + (3, 3)), ex(s2),
    )
    sel = torch.argsort(dist, dim=-1, stable=True)[..., :2]
    g3 = sel[..., None].expand(sel.shape + (3,))
    return (torch.gather(dist, -1, sel), torch.gather(pos, -2, g3), torch.gather(nrm, -2, g3))


def _any_orth(v):
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=v.dtype, device=v.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=v.dtype, device=v.device)
    helper = torch.where((torch.abs(v[..., 0]) < 0.5)[..., None], ex, ey)
    t = cross(v, helper)
    return t / (_norm(t)[..., None] + 1e-12)


def plane_cylinder(xp1, xm1, s1, xp2, xm2, s2):
    """Plane vs cylinder: both end-disc deep points + the perpendicular
    rim pair on the deeper disc."""
    n = _col(xm1, 2)
    r, hh = s2[..., 0:1], s2[..., 1:2]
    axis = _col(xm2, 2)
    na = _dot(n, axis)[..., None]
    rd = -(n - na * axis)
    rdn = _norm(rd)[..., None]
    safe_rd = torch.where(rdn > 1e-8, rd / (rdn + 1e-12), _any_orth(axis))
    perp = cross(axis, safe_rd)
    c_lo = xp2 - axis * hh
    c_hi = xp2 + axis * hh
    deep_c = torch.where((_dot(c_lo - xp1, n) < _dot(c_hi - xp1, n))[..., None], c_lo, c_hi)
    cands = torch.stack([c_lo + safe_rd * r, c_hi + safe_rd * r,
                         deep_c + perp * r, deep_c - perp * r], dim=-2)
    dist = _dot(cands - xp1[..., None, :], n[..., None, :])
    pos = cands - 0.5 * dist[..., None] * n[..., None, :]
    return dist, pos, _tile(n, 4)


def plane_ellipsoid(xp1, xm1, s1, xp2, xm2, s2):
    """Plane vs ellipsoid: support point along -n."""
    n = _col(xm1, 2)
    local = _rot_t(xm2, -n)
    v = s2 * s2 * local
    v = v / (_norm(s2 * local)[..., None] + 1e-12)
    p = xp2 + _rot(xm2, v)
    dist = _dot(p - xp1, n)
    pos = p - 0.5 * dist[..., None] * n
    return dist[..., None], pos[..., None, :], n[..., None, :]
