"""Collision driver: static pair table -> fixed-size Contact set.

Counterpart of `robogym_tpu/physics/collision/driver.py`, batched over
envs. Pairs are grouped at model-build time by (collider kind, geom types,
contacts per pair); per group a bounding-capsule broadphase scores every
pair, the deepest K are kept, and the narrowphase runs on those winners
only: the analytic primitives, the box-box kernel, or the hull kernels.
The slot layout is static, so the constraint stage knows each slot's facet
structure.

Where the JAX package gathers through one-hot matmuls (a TPU workaround),
this port indexes directly; the values are the same. The broadphase ranks
its scores in bfloat16 and breaks ties toward the lower pair index, as
`lax.top_k` does, through a stable sort. Geom and body ids travel through
the float contact table and come back by rounding, as in the JAX package.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Tuple

import numpy as np
import torch

from robogym_torch.mjcf.model import Contact, Data, GeomType, JointType, Model, ModelConst
from robogym_torch.physics.collision import boxbox_kernel, convex_kernel
from robogym_torch.physics.collision import primitives as prim
from robogym_torch.physics.collision.convex import DIRS12, support_multi
from robogym_torch.physics.tables import on_device
from robogym_torch.utils.rotation import cross

BIG = 1e10

_PLANE_PRIM = {
    GeomType.SPHERE: (prim.plane_sphere, 1),
    GeomType.CAPSULE: (prim.plane_capsule, 2),
    GeomType.BOX: (prim.plane_box, 8),
    GeomType.CYLINDER: (prim.plane_cylinder, 4),
    GeomType.ELLIPSOID: (prim.plane_ellipsoid, 1),
}
_PRIM = {
    (GeomType.SPHERE, GeomType.SPHERE): (prim.sphere_sphere, 1),
    (GeomType.SPHERE, GeomType.CAPSULE): (prim.sphere_capsule, 1),
    (GeomType.SPHERE, GeomType.BOX): (prim.sphere_box, 1),
    (GeomType.CAPSULE, GeomType.CAPSULE): (prim.capsule_capsule, 1),
    (GeomType.CAPSULE, GeomType.BOX): (prim.capsule_box, 2),
    # the 17-slot SAT manifold in one kernel, looked up when called (as the
    # hull kernels are) so that a caller may route it to its plain version
    (GeomType.BOX, GeomType.BOX): (lambda *sides: boxbox_kernel.boxbox(*sides), 17),
}
_CONVEX_TYPES = (
    GeomType.SPHERE, GeomType.CAPSULE, GeomType.CYLINDER,
    GeomType.ELLIPSOID, GeomType.BOX, GeomType.MESH,
)
_HULL_TYPES = (GeomType.BOX, GeomType.MESH)

DEFAULT_GROUP_CAP = 48
KIND_GROUP_CAP = {"convex": 8, "box_convex": 32, "plane_convex": 8}
KIND_GROUP_CAP_DENSE = {"convex": 16, "box_convex": 32, "plane_convex": 8}


@functools.lru_cache(maxsize=32)
def build_groups(const: ModelConst, group_cap: int = DEFAULT_GROUP_CAP):
    """Static grouping of the pair table: a list of dicts with kind, fn,
    ncon, t1/t2, g1/g2/condim (numpy) and the active budget K."""
    pairs = const.collision_pairs
    groups: Dict[Tuple, Dict] = {}
    for p in range(len(pairs)):
        g1, g2 = int(pairs[p, 0]), int(pairs[p, 1])
        t1, t2 = int(const.geom_type[g1]), int(const.geom_type[g2])
        condim = max(int(const.geom_condim[g1]), int(const.geom_condim[g2]))
        if t1 == GeomType.PLANE:
            if t2 in _PLANE_PRIM:
                kind, fn, ncon = "plane_prim", _PLANE_PRIM[t2][0], _PLANE_PRIM[t2][1]
            else:
                kind, fn, ncon = "plane_convex", None, 4
        elif (t1, t2) in _PRIM:
            kind, fn, ncon = "prim", _PRIM[(t1, t2)][0], _PRIM[(t1, t2)][1]
        elif t1 == GeomType.BOX and t2 == GeomType.MESH:
            kind, fn, ncon = "box_convex", None, 4
        elif t1 in _CONVEX_TYPES and t2 in _CONVEX_TYPES:
            # hull-hull pairs touching a free body get a 4-point manifold;
            # articulated-link pairs keep a single point
            both_hull = t1 in _HULL_TYPES and t2 in _HULL_TYPES
            has_free = _touches_free_body(const, g1) or _touches_free_body(const, g2)
            kind, fn, ncon = "convex", None, 4 if (both_hull and has_free) else 1
        else:
            continue
        key = (kind, t1, t2, ncon)
        grp = groups.setdefault(
            key, dict(kind=kind, fn=fn, ncon=ncon, t1=t1, t2=t2, g1=[], g2=[], condim=[]))
        grp["g1"].append(g1)
        grp["g2"].append(g2)
        grp["condim"].append(condim)

    out = []
    for key in sorted(groups.keys()):
        grp = groups[key]
        grp["g1"] = np.asarray(grp["g1"], np.int64)
        grp["g2"] = np.asarray(grp["g2"], np.int64)
        grp["condim"] = np.asarray(grp["condim"], np.int32)
        n = len(grp["g1"])
        cap = KIND_GROUP_CAP.get(grp["kind"], group_cap)
        if group_cap > DEFAULT_GROUP_CAP:
            base = KIND_GROUP_CAP_DENSE.get(grp["kind"], cap)
            cap = max(base, base * group_cap // DEFAULT_GROUP_CAP)
        grp["K"] = min(n, cap)
        out.append(grp)
    return out


def _touches_free_body(const: ModelConst, g: int) -> bool:
    root = int(const.body_rootid[int(const.geom_bodyid[g])])
    adr = int(const.body_jntadr[root])
    num = int(const.body_jntnum[root])
    return any(int(const.jnt_type[j]) == JointType.FREE for j in range(adr, adr + num))


def contact_slot_layout(const: ModelConst, group_cap: int = DEFAULT_GROUP_CAP) -> List[int]:
    """Static per-slot upper bound on condim, in Contact row order."""
    condims: List[int] = []
    for grp in build_groups(const, group_cap):
        condims.extend([int(grp["condim"].max())] * (grp["K"] * grp["ncon"]))
    return condims


def n_contact_slots(const: ModelConst, group_cap: int = DEFAULT_GROUP_CAP) -> int:
    return len(contact_slot_layout(const, group_cap))


@functools.lru_cache(maxsize=32)
def slot_winner_rows(const: ModelConst, group_cap: int = DEFAULT_GROUP_CAP) -> np.ndarray:
    """Static (ncon_total,) index of the `wtab` row each slot reads."""
    rows: List[int] = []
    base = 0
    for grp in build_groups(const, group_cap):
        rows.extend(np.repeat(base + np.arange(grp["K"]), grp["ncon"]).tolist())
        base += grp["K"]
    return np.asarray(rows, np.int64)


@functools.lru_cache(maxsize=32)
def n_winner_rows(const: ModelConst, group_cap: int = DEFAULT_GROUP_CAP) -> int:
    return sum(g["K"] for g in build_groups(const, group_cap))


def _orthogonal(n: torch.Tensor) -> torch.Tensor:
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    helper = torch.where(torch.abs(n[..., :1]) < 0.5, ex, ey)
    t = cross(n, helper)
    return t / (torch.sqrt(torch.sum(t * t, dim=-1, keepdim=True)) + 1e-12)


def contact_frame(normal: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) frames [normal, tan1, tan2] from contact normals."""
    t1v = _orthogonal(normal)
    return torch.stack([normal, t1v, cross(normal, t1v)], dim=-2)


def _mix_params(m: Model, g1, g2):
    """Contact solref/solimp/friction/margin/gap for static pair ids; the
    solref (B, n, 2), solimp (B, n, 5) or friction (B, n, 5) where the
    model's geom solref, solimp or friction is each env's own (read by
    `Model.take`, which indexes a per-env field's geom axis)."""
    p1, p2 = m.geom_priority[g1], m.geom_priority[g2]
    m1, m2 = m.geom_solmix[g1], m.geom_solmix[g2]
    w1 = m1 / torch.clamp(m1 + m2, min=1e-12)
    half, zero, one = (torch.full_like(w1, v) for v in (0.5, 0.0, 1.0))
    w1 = torch.where((m1 < 1e-12) & (m2 < 1e-12), half, w1)
    w1 = torch.where((m1 < 1e-12) & (m2 >= 1e-12), zero, w1)
    w1 = torch.where((m2 < 1e-12) & (m1 >= 1e-12), one, w1)
    w1 = w1[:, None]
    sr1, sr2 = m.take("geom_solref", g1), m.take("geom_solref", g2)
    si1, si2 = m.take("geom_solimp", g1), m.take("geom_solimp", g2)
    f1, f2 = m.take("geom_friction", g1), m.take("geom_friction", g2)
    solref_mix = w1 * sr1 + (1 - w1) * sr2
    direct = (sr1[..., 0] <= 0) | (sr2[..., 0] <= 0)
    solref = torch.where(direct[..., None], torch.minimum(sr1, sr2), solref_mix)
    solimp = w1 * si1 + (1 - w1) * si2
    fric = torch.maximum(f1, f2)
    margin = torch.maximum(m.geom_margin[g1], m.geom_margin[g2])
    gap = torch.maximum(m.geom_gap[g1], m.geom_gap[g2])
    use1 = (p1 > p2)[:, None]
    use2 = (p2 > p1)[:, None]
    solref = torch.where(use1, sr1, torch.where(use2, sr2, solref))
    solimp = torch.where(use1, si1, torch.where(use2, si2, solimp))
    fric = torch.where(use1, f1, torch.where(use2, f2, fric))
    friction5 = torch.stack([fric[..., 0], fric[..., 0], fric[..., 1], fric[..., 2], fric[..., 2]],
                            dim=-1)
    return solref, solimp, friction5, margin, gap


def _model_cache(m: Model, group_cap: int):
    """Model-only quantities, computed once per Model: per-group pair
    tables (solver params + ids; (B, n, 19) where the geom solref, solimp
    or friction is each env's own), mesh tables in the local frame and the
    local bounding-capsule fits of the meshes. Where `mesh_convex_vert` is
    each env's own (a mesh env's per-episode hulls), the mesh tables are
    too: verts (B, ngeom, 3, V), 4 * 3 * V bytes a geom and env, and the
    capsules (B, nmesh, ...)."""
    key = f"_collision_cache_{group_cap}"
    cache = m.__dict__.get(key)
    if cache is not None:
        return cache
    c = m.const
    dev, dtype = m.device, m.dtype
    bodyid = np.asarray(c.geom_bodyid, np.int64)
    groups = []
    for grp in build_groups(c, group_cap):
        g1 = torch.as_tensor(grp["g1"], device=dev)
        g2 = torch.as_tensor(grp["g2"], device=dev)
        solref, solimp, fric5, margin, gap = _mix_params(m, g1, g2)
        n = len(grp["g1"])

        def col(a):
            return torch.as_tensor(np.asarray(a, np.float32), dtype=dtype, device=dev)[:, None].expand(n, 1)

        parts = [solref, solimp, fric5, margin[:, None], gap[:, None],
                 col(grp["condim"]), col(grp["g1"]), col(grp["g2"]),
                 col(bodyid[grp["g1"]]), col(bodyid[grp["g2"]])]
        lead = torch.broadcast_shapes(*(p.shape[:-2] for p in parts))
        ptab = torch.cat([p.expand(lead + p.shape[-2:]) for p in parts], dim=-1)  # (n, 19)
        groups.append(dict(g1=g1, g2=g2, ptab=ptab, margin=margin))
    cache = dict(groups=groups)
    if c.nmesh:
        mids = torch.as_tensor(np.clip(c.geom_dataid, 0, c.nmesh - 1).astype(np.int64), device=dev)
        verts = m.mesh_convex_vert[..., mids, :, :].transpose(-1, -2)  # ([B,] ngeom, 3, V)
        mask = m.mesh_convex_mask[..., mids, :]                        # ([B,] ngeom, V)
        cloc = m.mesh_convex_center[..., mids, :]                      # ([B,] ngeom, 3)
        # padded verts parked at the local center: never a support point
        vloc = torch.where(mask[..., None, :] > 0, verts, cloc[..., :, None])
        cache["mesh"] = (vloc.contiguous(), mask, cloc)
        cache["mesh_capsule"] = _mesh_capsules(m)
    object.__setattr__(m, key, cache)
    return cache


def _mesh_capsules(m: Model):
    """Local bounding capsules of the meshes: endpoints ([B,] nmesh, 3) x2
    and radius ([B,] nmesh), about the principal axis of the vertex
    covariance; per env where the mesh table is."""
    mv = m.mesh_convex_vert
    mask = m.mesh_convex_mask > 0
    ctr = m.mesh_convex_center
    cv = torch.where(mask[..., None], mv - ctr[..., :, None, :], torch.zeros_like(mv))
    C = torch.einsum("...mvi,...mvj->...mij", cv, cv)
    u = torch.full(C.shape[:-1], 1.0 / np.sqrt(3.0), dtype=mv.dtype, device=mv.device)
    for _ in range(8):
        u = torch.einsum("...mij,...mj->...mi", C, u)
        u = u / (torch.linalg.vector_norm(u, dim=-1, keepdim=True) + 1e-20)
    tp = torch.einsum("...mvi,...mi->...mv", cv, u)
    zero = torch.zeros_like(tp)
    tmin = torch.min(torch.where(mask, tp, zero), dim=-1).values
    tmax = torch.max(torch.where(mask, tp, zero), dim=-1).values
    perp = cv - tp[..., None] * u[..., None, :]
    rper = torch.sqrt(torch.max(torch.where(mask, torch.sum(perp * perp, dim=-1), zero),
                                dim=-1).values)
    return ctr + u * tmin[..., None], ctr + u * tmax[..., None], rper


def geom_capsules(m: Model, d: Data):
    """Per-geom conservative world-frame bounding capsule: endpoints
    (B, ngeom, 3) x2 and radius (ngeom,), or (B, ngeom) where the geom
    sizes or the mesh table are each env's own."""
    c = m.const
    t = np.asarray(c.geom_type)
    s = m.geom_size
    dev, dtype = s.device, s.dtype
    xp, xm = d.geom_xpos, d.geom_xmat

    def flag(name, v):
        return on_device(c, "cap_" + name, v, dev)

    is_zaxis = flag("z", (t == GeomType.CAPSULE) | (t == GeomType.CYLINDER))
    is_long = flag("long", (t == GeomType.BOX) | (t == GeomType.ELLIPSOID))
    smax = torch.max(s, dim=-1, keepdim=True).values
    winners = s >= smax
    # first longest axis only (averaging tied axes misses cube corners)
    axis_long = (winners & (torch.cumsum(winners.to(torch.int32), dim=-1) == 1)).to(dtype)
    zaxis = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev).expand(c.ngeom, 3)
    u_loc = torch.where(is_zaxis[:, None], zaxis, torch.where(is_long[:, None], axis_long, zaxis))
    zero = torch.zeros_like(s[..., 0])
    halflen = torch.where(is_zaxis, s[..., 1], torch.where(is_long, smax[..., 0], zero))
    sq = torch.sum(s * s, dim=-1)
    r_perp_box = torch.sqrt(torch.clamp(sq - smax[..., 0] ** 2, min=0.0))
    radius = torch.where(is_zaxis, s[..., 0], torch.where(is_long, r_perp_box, s[..., 0]))
    radius = torch.where(flag("plane", t == GeomType.PLANE), zero, radius)
    off_loc = u_loc * halflen[..., None]
    if c.nmesh:
        a_loc_m, b_loc_m, rper = _model_cache(m, m.opt.group_cap)["mesh_capsule"]
        mids = on_device(c, "cap_mids", np.clip(c.geom_dataid, 0, c.nmesh - 1), dev, torch.long)
        is_mesh = flag("mesh", t == GeomType.MESH)
        a_loc = torch.where(is_mesh[:, None], a_loc_m[..., mids, :], -off_loc)
        b_loc = torch.where(is_mesh[:, None], b_loc_m[..., mids, :], off_loc)
        radius = torch.where(is_mesh, rper[..., mids], radius)
    else:
        a_loc, b_loc = -off_loc, off_loc
    spec = "xgij,xgj->xgi" if a_loc.dim() == 3 else "xgij,gj->xgi"
    a_w = xp + torch.einsum(spec, xm, a_loc)
    b_w = xp + torch.einsum(spec, xm, b_loc)
    return a_w, b_w, radius


def deepest_k(score: torch.Tensor, K: int):
    """The K highest broadphase scores of each row of (B, n), ranked in
    bfloat16 with ties going to the lower pair index, as `lax.top_k` on
    bf16 scores does (a stable descending sort). Returns (sel (B, K),
    live (B, K): the rounded score is > 0)."""
    ranked = torch.sort(score.to(torch.bfloat16).to(score.dtype), dim=-1, descending=True,
                        stable=True)
    return ranked.indices[:, :K], ranked.values[:, :K] > 0


def _seg_seg_dist(p1, q1, p2, q2):
    """Min distance between segments [p1,q1] and [p2,q2] (..., 3)."""
    eps = 1e-12
    d1 = q1 - p1
    d2 = q2 - p2
    r = p1 - p2
    a = torch.sum(d1 * d1, -1)
    e = torch.sum(d2 * d2, -1)
    f = torch.sum(d2 * r, -1)
    cc = torch.sum(d1 * r, -1)
    b = torch.sum(d1 * d2, -1)
    denom = a * e - b * b
    zero = torch.zeros_like(a)
    s = torch.where(denom > eps, torch.clamp((b * f - cc * e) / (denom + eps), 0.0, 1.0), zero)
    t = torch.where(e > eps, (b * s + f) / (e + eps), zero)
    t_cl = torch.clamp(t, 0.0, 1.0)
    s = torch.where(
        torch.abs(t - t_cl) > 0,
        torch.clamp(torch.where(a > eps, (b * t_cl - cc) / (a + eps), zero), 0.0, 1.0),
        s,
    )
    cp1 = p1 + d1 * s[..., None]
    cp2 = p2 + d2 * t_cl[..., None]
    return torch.linalg.vector_norm(cp1 - cp2, dim=-1)


def _scores(m: Model, d: Data, grp, gc, caps):
    """Broadphase clearance scores (B, n): > 0 means the capsule bound
    cannot rule the pair out."""
    cap_a, cap_b, cap_r = caps
    g1, g2 = gc["g1"], gc["g2"]
    xp1 = d.geom_xpos[:, g1]
    if grp["kind"].startswith("plane"):
        nrm = d.geom_xmat[:, g1, :, 2]
        ha = torch.sum((cap_a[:, g2] - xp1) * nrm, dim=-1)
        hb = torch.sum((cap_b[:, g2] - xp1) * nrm, dim=-1)
        return cap_r[..., g2] + gc["margin"] - torch.minimum(ha, hb)
    sdist = _seg_seg_dist(cap_a[:, g1], cap_b[:, g1], cap_a[:, g2], cap_b[:, g2])
    return cap_r[..., g1] + cap_r[..., g2] + gc["margin"] - sdist


def broadphase_scores(m: Model, d: Data, group_cap: int = DEFAULT_GROUP_CAP):
    """Per-group broadphase scores (B, n), the same math as `collision`."""
    caps = geom_capsules(m, d)
    gcs = _model_cache(m, group_cap)["groups"]
    return [_scores(m, d, grp, gc, caps) for grp, gc in zip(build_groups(m.const, group_cap), gcs)]


def _side(m: Model, d: Data, G: torch.Tensor, gtype: int, cache, need_mask=False):
    """Per-geom quantities of one pair side for winner geom ids G (B, K)."""
    bi = torch.arange(G.shape[0], device=G.device)[:, None]
    data = dict(xpos=d.geom_xpos[bi, G], xmat=d.geom_xmat[bi, G], size=m.take("geom_size", G))
    if gtype == GeomType.MESH:
        vloc, mask, cloc = cache["mesh"]

        def rows(t, shared_dim):                # each env's own rows where t is per env
            return t[bi, G] if t.dim() > shared_dim else t[G]

        data["vloc"] = rows(vloc, 3)
        if need_mask:
            data["mask"] = rows(mask, 2)
        data["center"] = data["xpos"] + torch.einsum("xkij,xkj->xki", data["xmat"],
                                                     rows(cloc, 2))
    else:
        data["center"] = data["xpos"]
    return data


def _hull_locs(t, data):
    """Local padded verts (B, K, 3, V), row-major rotation (B, K, 9), origin
    and world center (B, K, 3) of a box (8 corners) or mesh side."""
    xm9 = data["xmat"].reshape(data["xmat"].shape[:-2] + (9,)).contiguous()
    if t == GeomType.BOX:
        signs = prim._signs(data["size"])                              # (8, 3)
        local = signs.T * data["size"][..., :, None]                   # (B, K, 3, 8)
        return local.contiguous(), xm9, data["xpos"].contiguous(), data["xpos"].contiguous()
    return data["vloc"].contiguous(), xm9, data["xpos"].contiguous(), data["center"].contiguous()


def _box_face_normals(xmat: torch.Tensor) -> torch.Tensor:
    """A box's six face normals (..., 6, 3): its axes, then their negatives."""
    xt = xmat.transpose(-1, -2)
    return torch.cat([xt, -xt], dim=-2)


def _hull_extra_dirs(t1, t2, data1, data2):
    """Per-pair extra separating-axis candidates: box face normals."""
    for t, data in ((t1, data1), (t2, data2)):
        if t == GeomType.BOX:
            return _box_face_normals(data["xmat"]).contiguous(), 6
    c = data1["center"]
    return torch.zeros(c.shape[:-1] + (1, 3), dtype=c.dtype, device=c.device), 0


def _hull_args(t1, t2, data1, data2):
    v1l, xm1, xp1, c1 = _hull_locs(t1, data1)
    v2l, xm2, xp2, c2 = _hull_locs(t2, data2)
    xd, DX = _hull_extra_dirs(t1, t2, data1, data2)
    return (v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd), DX


def _best_direction(t1, t2, data1, data2, dirs):
    """The direction of `dirs` (B, K, D, 3) with the least separation
    (first on ties) and that separation: (n (B, K, 3), sep (B, K))."""
    p1 = support_multi(t1, data1, dirs)
    p2 = support_multi(t2, data2, -dirs)
    seps = torch.sum(dirs * (p1 - p2), dim=-1)
    k = torch.argmin(seps, dim=-1, keepdim=True)
    n = torch.gather(dirs, -2, k[..., None].expand(k.shape + (3,)))[..., 0, :]
    return n, torch.gather(seps, -1, k)[..., 0]


def _collide_round_group(t1, t2, data1, data2):
    """Single-point convex collision of pairs with a round geom (sphere,
    capsule, cylinder or ellipsoid) by support functions, as the JAX
    driver's `_collide_convex_group`: the least separation over the 12
    shared directions, the centre line and any box's face normals, refined
    twice on a ring of 8 directions about the incumbent (radius 0.3, then
    0.08). Returns dist (B, K), pos (B, K, 3), normal (B, K, 3)."""
    c1, c2 = data1["center"], data2["center"]
    d0 = c2 - c1
    d0 = d0 / (torch.linalg.vector_norm(d0, dim=-1, keepdim=True) + 1e-12)
    dirs = [torch.as_tensor(DIRS12, dtype=c1.dtype, device=c1.device).expand(
        c1.shape[:-1] + DIRS12.shape), d0[..., None, :]]
    dirs += [_box_face_normals(d["xmat"]) for t, d in ((t1, data1), (t2, data2))
             if t == GeomType.BOX]
    n, s_best = _best_direction(t1, t2, data1, data2, torch.cat(dirs, dim=-2))
    ring = torch.as_tensor(convex_kernel.ring_np(), dtype=c1.dtype, device=c1.device)
    for radius in convex_kernel.RING_RADII:
        t1v = _orthogonal(n)
        t2v = cross(n, t1v)
        cand = n[..., None, :] + radius * (ring[:, :1] * t1v[..., None, :]
                                           + ring[:, 1:] * t2v[..., None, :])
        cand = cand / (torch.linalg.vector_norm(cand, dim=-1, keepdim=True) + 1e-12)
        n, s_best = _best_direction(t1, t2, data1, data2,
                                    torch.cat([n[..., None, :], cand], dim=-2))
    nd = n[..., None, :]
    p1 = support_multi(t1, data1, nd)[..., 0, :]
    p2 = support_multi(t2, data2, -nd)[..., 0, :]
    return -s_best, 0.5 * (p1 + p2), n


def _plane_convex(data1, data2):
    """Plane vs hull: the 4 deepest world verts by iterative min-extract
    with a depth-relative index ramp (ties go to the lower index)."""
    nrm = data1["xmat"][..., :, 2]                                     # (B, K, 3)
    wv = data2["xpos"][..., :, None] + torch.matmul(data2["xmat"], data2["vloc"])
    rel = wv - data1["xpos"][..., :, None]
    vd = torch.sum(rel * nrm[..., :, None], dim=-2)                    # (B, K, V)
    vd = torch.where(data2["mask"] > 0, vd, torch.full_like(vd, BIG))
    V = vd.shape[-1]
    scale = torch.clamp(torch.amax(torch.abs(vd), dim=(-2, -1)), min=1.0) * 1e-6
    ramp = torch.arange(V, device=vd.device).to(vd.dtype) * scale[:, None, None]
    sel_vd = vd + ramp
    dists, picks = [], []
    for _ in range(4):
        mn = torch.min(sel_vd, dim=-1, keepdim=True).values
        w = (sel_vd <= mn).to(vd.dtype)
        w = w / torch.clamp(torch.sum(w, -1, keepdim=True), min=1.0)
        dists.append(torch.sum(vd * w, dim=-1))
        picks.append(torch.sum(wv * w[..., None, :], dim=-1))
        sel_vd = sel_vd + w * BIG
    dist = torch.stack(dists, dim=-1)
    pos = torch.stack(picks, dim=-2) - 0.5 * dist[..., None] * nrm[..., None, :]
    return dist, pos, nrm[..., None, :].expand(pos.shape)


def collision(m: Model, d: Data, group_cap: int = DEFAULT_GROUP_CAP) -> Data:
    """Fill d.contact. The slot layout is static given (const, group_cap)."""
    c = m.const
    if len(c.collision_pairs) == 0:
        return d
    B = d.qpos.shape[0]
    dtype = d.qpos.dtype
    groups = build_groups(c, group_cap)
    cache = _model_cache(m, group_cap)
    caps = geom_capsules(m, d)
    blocks, wtabs = [], []

    for grp, gc in zip(groups, cache["groups"]):
        n = len(grp["g1"])
        K, ncon = grp["K"], grp["ncon"]
        score = _scores(m, d, grp, gc, caps)                           # (B, n)
        if K < n:
            sel, active_bp = deepest_k(score, K)
            ptab = gc["ptab"]                                          # (n, 19) or (B, n, 19)
            pk = ptab[torch.arange(B, device=sel.device)[:, None], sel] if ptab.dim() == 3 \
                else ptab[sel]                                         # (B, K, 19)
            G1, G2 = gc["g1"][sel], gc["g2"][sel]
        else:
            active_bp = score > 0
            pk = gc["ptab"].expand(B, n, 19)
            G1, G2 = gc["g1"].expand(B, n), gc["g2"].expand(B, n)

        t1, t2 = grp["t1"], grp["t2"]
        if grp["kind"] in ("plane_prim", "prim"):
            d1, d2 = _side(m, d, G1, t1, cache), _side(m, d, G2, t2, cache)
            dist, pos, normal = grp["fn"](d1["xpos"], d1["xmat"], d1["size"],
                                          d2["xpos"], d2["xmat"], d2["size"])
        elif grp["kind"] == "plane_convex":
            dist, pos, normal = _plane_convex(_side(m, d, G1, t1, cache),
                                              _side(m, d, G2, t2, cache, need_mask=True))
        elif t1 in _HULL_TYPES and t2 in _HULL_TYPES:
            args, DX = _hull_args(t1, t2, _side(m, d, G1, t1, cache), _side(m, d, G2, t2, cache))
            if grp["kind"] == "box_convex" or ncon == 4:
                dist, pos, n_ = convex_kernel.hull_manifold(*args, DX)
                normal = n_[..., None, :].expand(pos.shape)
            else:
                dist, pos, n_, _ = convex_kernel.hull_pair(*args, DX)
                dist, pos, normal = dist[..., None], pos[..., None, :], n_[..., None, :]
        else:
            dist, pos, n_ = _collide_round_group(t1, t2, _side(m, d, G1, t1, cache),
                                                 _side(m, d, G2, t2, cache))
            dist, pos, normal = dist[..., None], pos[..., None, :], n_[..., None, :]

        dist = torch.where(active_bp[..., None], dist, torch.full_like(dist, BIG))
        wincols = torch.cat([(pk[..., 12] - pk[..., 13])[..., None], pk[..., 14:19]], dim=-1)
        blocks.append(torch.cat([
            pos.reshape(B, K * ncon, 3).to(dtype),
            normal.reshape(B, K * ncon, 3).to(dtype),
            dist.reshape(B, K * ncon, 1).to(dtype),
            torch.repeat_interleave(wincols, ncon, dim=1),
        ], dim=-1))
        wtabs.append(pk[..., 0:12])

    tab = torch.cat(blocks, dim=1)                                     # (B, ncon, 13)
    dist = tab[..., 6]
    includemargin = tab[..., 7]

    def as_i32(col):
        return torch.round(col).to(torch.int32)

    contact = Contact(
        dist=dist, pos=tab[..., 0:3], normal=tab[..., 3:6], includemargin=includemargin,
        geom1=as_i32(tab[..., 9]), geom2=as_i32(tab[..., 10]),
        active=dist < includemargin, condim=as_i32(tab[..., 8]),
        body1=as_i32(tab[..., 11]), body2=as_i32(tab[..., 12]),
        wtab=torch.cat(wtabs, dim=1).to(dtype),
    )
    return d.replace(contact=contact)
