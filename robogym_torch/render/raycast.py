"""An analytic raycast renderer over the model's geoms, batched over envs.

Counterpart of `robogym_tpu/render/raycast.py`, in plain PyTorch: primary
rays through the pixel grid of a camera, closed-form intersections by geom
type (plane, sphere, capsule, cylinder, ellipsoid, box) and the hull of a
mesh clipped by its face planes (`Model.mesh_face_plane`, `mesh_face_mask`),
then a Lambertian shade of the nearest hit by the headlight and the model's
`<light>`s, over a vertical sky gradient. MuJoCo's camera convention: the
camera looks along its local -Z, +X right, +Y up, `fovy` vertical degrees.
Geoms with rgba alpha below 0.1 are invisible.

Every function takes a batch of B envs: Data fields (B, ...), and each
camera, light and geom field read per env where the model carries it so
(`Model.take`). The nearest geom of a type group is taken by `argmin` and
gathered (the JAX package averages tied geoms by one-hot max-compares, the
TPU's fast path; the two differ only where two depths tie exactly). Mesh
hulls are clipped face by face with a running entry and exit depth and the
entering face, and envs are taken in chunks whose intermediates fit the
device's free memory (`env_chunk`); `LAST_CHUNK` keeps the last render's
chunk size.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from robogym_torch.mjcf.model import Data, GeomType, Model
from robogym_torch.utils import rotation

BIG = 1e9
# floats held per (env, geom, pixel) by the largest type group's
# intersection (rays in the geom's frame, depths, the hull's running
# entry, exit and face), for `env_chunk`
FLOATS_PER_RAY = 12
# the share of the device's free memory a render's intermediates may take
MEMORY_SHARE = 0.5
LAST_CHUNK = {"envs": 0, "batch": 0}


def camera_id(m: Model, name: str) -> int:
    return m.const.names["camera"][name]


def _rows(m: Model, name: str, ids, B: int) -> torch.Tensor:
    """Rows `ids` of model field `name` for B envs: (B, k, ...), each env's
    own where the field is per env."""
    ids_t = torch.as_tensor(np.asarray(ids, np.int64).reshape(-1), device=m.device)
    v = m.take(name, ids_t)
    return v if m.per_env(name) else v.expand((B,) + tuple(v.shape))


def _scalar(m: Model, name: str, B: int) -> torch.Tensor:
    """A scalar model field for B envs: (B,)."""
    v = getattr(m, name)
    return v.reshape(-1).expand(B) if not m.per_env(name) else v.reshape(B)


def camera_pose(m: Model, d: Data, cam: int):
    """World (pos (B, 3), mat (B, 3, 3)) of camera `cam`."""
    B = d.xpos.shape[0]
    bid = int(m.const.cam_bodyid[cam])
    R_local = rotation.quat2mat(_rows(m, "cam_quat", [cam], B)[:, 0])
    xmat = d.xmat[:, bid]
    pos = d.xpos[:, bid] + (xmat @ _rows(m, "cam_pos", [cam], B)[:, 0, :, None])[..., 0]
    return pos, xmat @ R_local


def _pixel_rays(fovy_deg: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Unit ray directions (B, P, 3) in the camera frame of each env's
    vertical field of view fovy_deg (B,), row 0 at the image's top."""
    dtype, dev = fovy_deg.dtype, fovy_deg.device
    tan = torch.tan(torch.deg2rad(fovy_deg) * 0.5)[:, None, None]
    ys = (1.0 - (torch.arange(H, dtype=dtype, device=dev) + 0.5) * (2.0 / H))
    xs = ((torch.arange(W, dtype=dtype, device=dev) + 0.5) * (2.0 / W) - 1.0) * (W / H)
    yg, xg = torch.meshgrid(ys, xs, indexing="ij")
    dirs = torch.stack([xg.reshape(1, -1) * tan[..., 0], yg.reshape(1, -1) * tan[..., 0],
                        -torch.ones((fovy_deg.shape[0], H * W), dtype=dtype, device=dev)], -1)
    return dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


# ---------------------------------------------------------------------------
# intersections by type, in the geom's frame: origin o (N, G, 3), directions
# v (N, G, P, 3), sizes (N, G, 3); each returns the depth t (N, G, P), BIG
# on a miss, and the local normal (N, G, P, 3)
# ---------------------------------------------------------------------------


def _safe(x: torch.Tensor, eps: float) -> torch.Tensor:
    return torch.where(torch.abs(x) < eps, torch.full_like(x, eps), x)


def _isect_plane(size, o, v):
    oz = o[..., None, 2]
    t = -oz / _safe(v[..., 2], 1e-9)
    hit = (t > 0) & (oz > 0)
    px = o[..., None, 0] + t * v[..., 0]
    py = o[..., None, 1] + t * v[..., 1]
    sx, sy = size[..., 0:1], size[..., 1:2]
    hit = hit & ((sx <= 0) | (torch.abs(px) <= sx)) & ((sy <= 0) | (torch.abs(py) <= sy))
    n = torch.zeros_like(v)
    n[..., 2] = 1.0
    return torch.where(hit, t, torch.full_like(t, BIG)), n


def _quadratic_entry(a, b, c):
    """The smaller root of a t^2 + 2 b t + c = 0; BIG without a real
    positive one."""
    disc = b * b - a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / _safe(a, 1e-12)
    return torch.where((disc >= 0) & (t > 0), t, torch.full_like(t, BIG))


def _isect_sphere(size, o, v):
    r = size[..., 0]
    oo = o[..., None, :].expand_as(v)
    b = (oo * v).sum(-1)
    c = (oo * oo).sum(-1) - r[..., None] ** 2
    t = _quadratic_entry(torch.ones_like(b), b, c)
    p = oo + t[..., None] * v
    return t, p / (r[..., None, None] + 1e-12)


def _isect_ellipsoid(size, o, v):
    s = size[..., None, :]
    os_ = o[..., None, :] / s
    vs = v / s
    t = _quadratic_entry((vs * vs).sum(-1), (os_ * vs).sum(-1), (os_ * os_).sum(-1) - 1.0)
    p = o[..., None, :] + t[..., None] * v
    n = p / (s * s)
    return t, n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)


def _side_hit(r, h, o, v):
    """The side of an infinite cylinder of radius r, within |z| <= h."""
    ox, oy, oz = o[..., None, 0], o[..., None, 1], o[..., None, 2]
    a = v[..., 0] ** 2 + v[..., 1] ** 2
    b = ox * v[..., 0] + oy * v[..., 1]
    c = (ox ** 2 + oy ** 2) - r[..., None] ** 2
    t = _quadratic_entry(a, b, c)
    z = oz + t * v[..., 2]
    t = torch.where(torch.abs(z) <= h[..., None], t, torch.full_like(t, BIG))
    p = o[..., None, :] + t[..., None] * v
    n = torch.stack([p[..., 0], p[..., 1], torch.zeros_like(p[..., 0])], -1)
    return t, n / (r[..., None, None] + 1e-12)


def _nearest_of(ts, ns):
    """Of candidate depths ts [(N, G, P)] and normals, the nearest; ties
    go to the earlier candidate."""
    t = ts[0]
    for x in ts[1:]:
        t = torch.minimum(t, x)
    n = ns[-1]
    for x, nx in zip(reversed(ts[:-1]), reversed(ns[:-1])):
        n = torch.where((t == x)[..., None], nx, n)
    return t, n


def _isect_capsule(size, o, v):
    r, h = size[..., 0], size[..., 1]
    t0, n0 = _side_hit(r, h, o, v)

    def cap(sign):
        ox, oy = o[..., None, 0], o[..., None, 1]
        oz = o[..., None, 2] - sign * h[..., None]
        b = ox * v[..., 0] + oy * v[..., 1] + oz * v[..., 2]
        cc = ox * ox + oy * oy + oz * oz - r[..., None] ** 2
        t = _quadratic_entry(torch.ones_like(b), b, cc)
        z = o[..., None, 2] + t * v[..., 2]
        t = torch.where(sign * z >= h[..., None], t, torch.full_like(t, BIG))
        p = torch.stack([ox + t * v[..., 0], oy + t * v[..., 1], oz + t * v[..., 2]], -1)
        return t, p / (r[..., None, None] + 1e-12)

    tc1, nc1 = cap(1.0)
    tc2, nc2 = cap(-1.0)
    return _nearest_of([t0, tc1, tc2], [n0, nc1, nc2])


def _isect_cylinder(size, o, v):
    r, h = size[..., 0], size[..., 1]
    t0, n0 = _side_hit(r, h, o, v)

    def disk(sign):
        t = (sign * h[..., None] - o[..., None, 2]) / _safe(v[..., 2], 1e-9)
        px = o[..., None, 0] + t * v[..., 0]
        py = o[..., None, 1] + t * v[..., 1]
        ok = (t > 0) & (px ** 2 + py ** 2 <= r[..., None] ** 2)
        n = torch.zeros_like(v)
        n[..., 2] = sign
        return torch.where(ok, t, torch.full_like(t, BIG)), n

    t1, n1 = disk(1.0)
    t2, n2 = disk(-1.0)
    return _nearest_of([t0, t1, t2], [n0, n1, n2])


def _isect_box(size, o, v):
    """The slab method; the normal of the entry axis (the first of tied
    axes; the JAX package averages them)."""
    inv = 1.0 / _safe(v, 1e-9)
    t1 = (-size[..., None, :] - o[..., None, :]) * inv
    t2 = (size[..., None, :] - o[..., None, :]) * inv
    tlo, thi = torch.minimum(t1, t2), torch.maximum(t1, t2)
    tin, axis = tlo.max(-1)
    tout = thi.min(-1).values
    t = torch.where((tin <= tout) & (tin > 0), tin, torch.full_like(tin, BIG))
    n = -torch.sign(v) * torch.nn.functional.one_hot(axis, 3).to(v.dtype)
    return t, n / (torch.linalg.norm(n, dim=-1, keepdim=True) + 1e-12)


def _isect_hull(planes, mask, o, v):
    """A convex hull from its face planes [n | off] (N, G, F, 4), n.x + off
    <= 0 inside, `mask` (N, G, F) the live faces: face by face, the running
    entry depth (the largest of the entering faces'), exit depth (the
    smallest of the leaving faces') and entering face."""
    N, G, P = v.shape[:3]
    F = int(mask.shape[-1])
    live = mask.reshape(-1, F).any(0).nonzero()
    F = int(live.max()) + 1 if live.numel() else 0
    tin = torch.full((N, G, P), -BIG, dtype=v.dtype, device=v.device)
    tout = torch.full_like(tin, BIG)
    face = torch.zeros((N, G, P), dtype=torch.long, device=v.device)
    outside = torch.zeros((N, G, P), dtype=torch.bool, device=v.device)
    for f in range(F):
        n = planes[..., f, :3]
        m = mask[..., f, None] > 0
        nd = (v * n[..., None, :]).sum(-1)
        no = ((n * o).sum(-1) + planes[..., f, 3])[..., None]
        t_pl = -no / _safe(nd, 1e-9)
        enter = m & (nd < 0) & (t_pl > tin)
        tin = torch.where(enter, t_pl, tin)
        face = torch.where(enter, f, face)
        tout = torch.where(m & (nd > 0), torch.minimum(tout, t_pl), tout)
        # a parallel face with the origin on its outer side excludes the ray
        outside |= m & (torch.abs(nd) < 1e-9) & (no > 0)
    t = torch.where((tin <= tout) & (tin > 0) & ~outside, tin, torch.full_like(tin, BIG))
    nrm = torch.gather(planes[..., :3], 2, face.reshape(N, G, P, 1).expand(N, G, P, 3)
                       if P else face[..., None].expand(N, G, P, 3))
    return t, nrm / (torch.linalg.norm(nrm, dim=-1, keepdim=True) + 1e-12)


_ISECT = {
    GeomType.PLANE: _isect_plane,
    GeomType.SPHERE: _isect_sphere,
    GeomType.CAPSULE: _isect_capsule,
    GeomType.CYLINDER: _isect_cylinder,
    GeomType.ELLIPSOID: _isect_ellipsoid,
    GeomType.BOX: _isect_box,
}


def env_chunk(m: Model, B: int, P: int) -> int:
    """Envs a render takes at once: all of B on the CPU; on the card as
    many as keep the largest type group's intermediates (FLOATS_PER_RAY
    floats an env, geom and pixel) within MEMORY_SHARE of the free device
    memory."""
    if m.device.type != "cuda":
        return B
    gtypes = np.asarray(m.const.geom_type)
    g_max = max(int((gtypes == t).sum()) for t in set(gtypes.tolist()))
    per_env = FLOATS_PER_RAY * torch.finfo(m.dtype).bits // 8 * g_max * P
    free, _ = torch.cuda.mem_get_info(m.device)
    return int(max(1, min(B, MEMORY_SHARE * free // per_env)))


def render_rgb(m: Model, d: Data, cam: int, height: int, width: int,
               geom_visible: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, 3) float images in [0, 1] from camera `cam`. `geom_visible`
    (ngeom,) or (B, ngeom): 0 hides a geom (the goal images hide the robot
    so); a geom of rgba alpha below 0.1 is hidden always."""
    cpos, cmat = camera_pose(m, d, cam)
    return render_rgb_pose(m, d, cpos, cmat, _rows(m, "cam_fovy", [cam], d.xpos.shape[0])[:, 0],
                           height, width, geom_visible)


def lookat_pose(eye, target, up=(0.0, 0.0, 1.0), dtype=torch.float32, device=None):
    """A camera's (pos (3,), mat (3, 3)) from `eye` towards `target`
    (MuJoCo's convention: -Z forward, +Y up), for a view with no
    `<camera>`."""
    eye = torch.as_tensor(eye, dtype=dtype, device=device)
    fwd = torch.as_tensor(target, dtype=dtype, device=device) - eye
    z = -fwd / (torch.linalg.norm(fwd) + 1e-12)
    x = torch.linalg.cross(torch.as_tensor(up, dtype=dtype, device=device), z)
    x = x / (torch.linalg.norm(x) + 1e-12)
    return eye, torch.stack([x, torch.linalg.cross(z, x), z], dim=1)


def render_rgb_pose(m: Model, d: Data, cpos: torch.Tensor, cmat: torch.Tensor,
                    fovy: torch.Tensor, height: int, width: int,
                    geom_visible: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`render_rgb` from each env's camera pose cpos (B, 3), cmat (B, 3, 3)
    (columns the camera's axes) and fovy (B,) degrees."""
    B = d.xpos.shape[0]
    chunk = env_chunk(m, B, height * width)
    LAST_CHUNK.update(envs=chunk, batch=B)
    if chunk >= B:
        return _render(m, d, cpos, cmat, fovy, height, width, geom_visible)
    from robogym_torch.envs import core

    out = []
    for s in range(0, B, chunk):
        envs = torch.arange(s, min(B, s + chunk), device=m.device)
        vis = geom_visible
        if vis is not None and torch.as_tensor(vis).dim() == 2:
            vis = vis[envs]
        out.append(_render(core.take_model_envs(m, envs), core.data_map(lambda x: x[envs], d),
                           cpos[envs], cmat[envs], fovy[envs], height, width, vis))
    return torch.cat(out)


def _render(m: Model, d: Data, cpos, cmat, fovy, height: int, width: int, geom_visible):
    c = m.const
    B = d.xpos.shape[0]
    dtype, dev = d.qpos.dtype, d.qpos.device
    P = height * width
    fovy = torch.as_tensor(fovy, dtype=dtype, device=dev).expand(B)
    rays = _pixel_rays(fovy, height, width) @ cmat.transpose(-1, -2)     # (B, P, 3)
    gtypes = np.asarray(c.geom_type)
    all_ids = np.arange(len(gtypes))
    rgba = _rows(m, "geom_rgba", all_ids, B)
    vis = (rgba[..., 3] > 0.1).to(dtype)
    if geom_visible is not None:
        vis = vis * torch.as_tensor(geom_visible, dtype=dtype, device=dev)

    t_best = torch.full((B, P), BIG, dtype=dtype, device=dev)
    rgb_best = torch.zeros((B, P, 3), dtype=dtype, device=dev)
    n_best = torch.zeros((B, P, 3), dtype=dtype, device=dev)
    for gt in sorted(set(int(t) for t in gtypes)):
        ids = np.nonzero(gtypes == gt)[0]
        ids_t = torch.as_tensor(ids, device=dev)
        gpos, gmat = d.geom_xpos[:, ids_t], d.geom_xmat[:, ids_t]           # (B, G, 3[, 3])
        o_l = torch.einsum("bgji,bgj->bgi", gmat, cpos[:, None] - gpos)
        v_l = torch.einsum("bgji,bpj->bgpi", gmat, rays)                     # (B, G, P, 3)
        if gt == GeomType.MESH:
            did = np.asarray(c.geom_dataid)[ids]
            t, n_l = _isect_hull(_rows(m, "mesh_face_plane", did, B),
                                 _rows(m, "mesh_face_mask", did, B), o_l, v_l)
        else:
            t, n_l = _ISECT[gt](_rows(m, "geom_size", ids, B), o_l, v_l)
        del v_l
        t = torch.where(vis[:, ids_t, None] > 0, t, torch.full_like(t, BIG))
        tg, g = t.min(1)                                                      # (B, P)
        n_g = torch.gather(n_l, 1, g[:, None, :, None].expand(B, 1, P, 3))[:, 0]
        R_g = torch.gather(gmat, 1, g[..., None, None].expand(B, P, 3, 3))
        n_w = (R_g @ n_g[..., None])[..., 0]
        rgb_g = torch.gather(rgba[:, ids_t, :3], 1, g[..., None].expand(B, P, 3))
        take = tg < t_best
        t_best = torch.where(take, tg, t_best)
        rgb_best = torch.where(take[..., None], rgb_g, rgb_best)
        n_best = torch.where(take[..., None], n_w, n_best)

    # shading: the headlight and the model's lights (Lambertian); their
    # poses and intensities are model fields, per env under vision
    # randomization
    n_best = n_best / (torch.linalg.norm(n_best, dim=-1, keepdim=True) + 1e-12)
    head = torch.clamp(-(n_best * rays).sum(-1), min=0.0)
    if c.nlight:
        hit = cpos[:, None, :] + torch.clamp(t_best, max=BIG)[..., None] * rays
        diffuse = torch.zeros_like(head)
        ambient = torch.zeros((B, 1), dtype=dtype, device=dev)
        lights = np.arange(c.nlight)
        lpos_l, ldir_l = _rows(m, "light_pos", lights, B), _rows(m, "light_dir", lights, B)
        l_act, l_dif = _rows(m, "light_active", lights, B), _rows(m, "light_diffuse", lights, B)
        l_amb = _rows(m, "light_ambient", lights, B)
        for i in range(c.nlight):
            b = int(c.light_bodyid[i])
            xmat = d.xmat[:, b]
            lpos = d.xpos[:, b] + (xmat @ lpos_l[:, i, :, None])[..., 0]
            ldir = (xmat @ ldir_l[:, i, :, None])[..., 0]
            ldir = ldir / (torch.linalg.norm(ldir, dim=-1, keepdim=True) + 1e-12)
            if bool(c.light_directional[i]):
                lam = torch.clamp(-(n_best * ldir[:, None, :]).sum(-1), min=0.0)
            else:
                to_l = lpos[:, None, :] - hit
                to_l = to_l / (torch.linalg.norm(to_l, dim=-1, keepdim=True) + 1e-12)
                lam = torch.clamp((n_best * to_l).sum(-1), min=0.0)
            diffuse = diffuse + (l_act[:, i] * l_dif[:, i])[:, None] * lam
            ambient = ambient + (l_act[:, i] * l_amb[:, i])[:, None]
        shade = torch.clamp(_scalar(m, "headlight_ambient", B)[:, None] + ambient
                            + _scalar(m, "headlight_diffuse", B)[:, None] * head + diffuse,
                            0.0, 1.0)
    else:
        # no light compiled in: a fixed headlight, sky and ambient
        sky = torch.clamp(n_best[..., 2], min=0.0)
        shade = torch.clamp(0.35 + 0.45 * head + 0.25 * sky, 0.0, 1.0)
    img = rgb_best * shade[..., None]

    # the background: a vertical gradient on the world ray's z
    bgt = 0.5 * (rays[..., 2] + 1.0)
    lo = torch.tensor([0.16, 0.21, 0.3], dtype=dtype, device=dev)
    hi = torch.tensor([0.45, 0.55, 0.66], dtype=dtype, device=dev)
    bg = lo * (1 - bgt[..., None]) + hi * bgt[..., None]
    img = torch.where((t_best < BIG)[..., None], img, bg)
    return img.reshape(B, height, width, 3)


def render_uint8(m: Model, d: Data, cam: int, height: int, width: int,
                 geom_visible: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB, as `sim.render()` returns it."""
    img = render_rgb(m, d, cam, height, width, geom_visible)
    return (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def render_camera(m: Model, d: Data, name: str, size: int,
                  geom_visible: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Camera `name` at a square `size` (the reference's image_size)."""
    return render_uint8(m, d, camera_id(m, name), size, size, geom_visible)
