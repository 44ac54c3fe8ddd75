"""Vert-hull convex narrowphase: the staged support sweep and its witness
points, as a single point (hull pair) or a 4-point manifold.

Counterpart of `robogym_tpu/physics/collision/convex_kernel.py`. Four
entry points, each a wrapper with a hand-written CUDA kernel
(`robogym_torch/csrc/hull_sweep.cu`) and its plain PyTorch version here:

  * `hull_pair` (replaces `_hull_kernel_loc`) and `hull_pair_world`
    (replaces `_hull_kernel`, the entry `_make_hull_core`): one contact
    point per pair; plain versions `hull_pair_plain` and
    `hull_pair_world_plain` (`_reference_hull_pair`).
  * `hull_manifold` (replaces `_manifold_kernel_loc`) and
    `hull_manifold_world` (replaces `_manifold_kernel`, the entry
    `_make_hull_manifold_core`): side-1 verts (box corners or a hull's
    verts) scored against the contact plane, the 4 deepest kept; plain
    versions `hull_manifold_plain` and `hull_manifold_world_plain`
    (`_reference_hull_manifold`).

The `_world` entries take each side as WORLD verts (B, K, 3, V). The others
take LOCAL verts (B, K, 3, V), a row-major rotation (B, K, 9) and an origin
(B, K, 3), and place them with `world_from_loc`, whose eager operations each
round once as the kernels' transform does. All take world centers c1/c2
(B, K, 3) and extra directions xd (B, K, max(DX, 1), 3) of which the first
DX are used.

Direction selection uses bfloat16 dots, as the JAX package does: verts are
centered and rounded to bf16, each direction is rounded to bf16, the three
exact products are summed in float32 and the sum is rounded to bf16. The
kernel repeats that arithmetic, so it picks the same direction except on
near-ties.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from robogym_torch.utils.rotation import cross

BIG = 1e10
MANIFOLD_TOL = 5e-3
MAX_VERTS = 64       # the compiler's MAX_HULL_VERTS: one warp holds two verts a lane
RING_N = 8
RING_RADII = (0.3, 0.08)


@functools.lru_cache(maxsize=1)
def ring_np() -> np.ndarray:
    theta = np.linspace(0, 2 * np.pi, RING_N, endpoint=False)
    return np.stack([np.cos(theta), np.sin(theta)], axis=-1).astype(np.float32)


@functools.lru_cache(maxsize=1)
def dirs12_np() -> np.ndarray:
    phi = (1 + 5**0.5) / 2
    ico = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        np.float32,
    )
    return ico / np.linalg.norm(ico, axis=1, keepdims=True)


def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 (nearest even), kept as float32."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _norm(a, keepdim=False):
    n = torch.sqrt(_dot3(a, a))
    return n[..., None] if keepdim else n


def world_from_loc(vloc, xm, xp):
    """vloc (..., 3, V), row-major rotation xm (..., 9), origin xp (..., 3)
    -> world verts (..., 3, V)."""
    R = xm.reshape(xm.shape[:-1] + (3, 3))
    rows = [
        xp[..., i, None] + ((R[..., i, 0, None] * vloc[..., 0, :]
                             + R[..., i, 1, None] * vloc[..., 1, :])
                            + R[..., i, 2, None] * vloc[..., 2, :])
        for i in range(3)
    ]
    return torch.stack(rows, dim=-2)


def _bf_dots(ds_bf, cv):
    """bf16 selection dots: ds_bf (..., D, 3) bf16-valued, cv (..., 3, V)
    bf16-valued -> (..., D, V), the f32 sum of exact products rounded."""
    return _bf(
        (ds_bf[..., 0, None] * cv[..., None, 0, :] + ds_bf[..., 1, None] * cv[..., None, 1, :])
        + ds_bf[..., 2, None] * cv[..., None, 2, :]
    )


def _sep_sel(ds, cv1, cv2, dc):
    """Selection separation along directions ds (..., D, 3): the bf16 support
    dots of the centered verts cv1/cv2 plus the f32 center term -> (..., D)."""
    dsb = _bf(ds)
    m1 = torch.max(_bf_dots(dsb, cv1), dim=-1).values
    m2 = torch.max(-_bf_dots(dsb, cv2), dim=-1).values
    return (m1 + m2) + _dot3(ds, dc[..., None, :])


def selection_score(v1, v2, c1, c2, n):
    """The sweep's selection separation of world verts (..., 3, V) along one
    direction n (..., 3) per pair, and its bf16 part |m1| + |m2|, whose
    rounding decides near-ties: (score (...), scale (...))."""
    cv1, cv2 = _bf(v1 - c1[..., None]), _bf(v2 - c2[..., None])
    nb = _bf(n)[..., None, :]
    m1 = torch.max(_bf_dots(nb, cv1), dim=-1).values[..., 0]
    m2 = torch.max(-_bf_dots(nb, cv2), dim=-1).values[..., 0]
    return _sep_sel(n[..., None, :], cv1, cv2, c1 - c2)[..., 0], m1.abs() + m2.abs()


def hull_pair_world_plain(v1, v2, c1, c2, xd, DX: int):
    """Plain version of the world-vertex hull-pair kernel, the sweep shared
    by all four entries, on world verts (B, K, 3, V): (dist (B, K),
    pos (B, K, 3), n (B, K, 3), p2 (B, K, 3))."""
    dev, f32 = v1.device, v1.dtype
    d0 = c2 - c1
    d0 = d0 / (_norm(d0, keepdim=True) + 1e-12)
    dirs12 = torch.as_tensor(dirs12_np(), device=dev).expand(c1.shape[:-1] + (12, 3))
    dirs = [dirs12, d0[..., None, :]]
    if DX:
        dirs.append(xd[..., :DX, :])
    dirs = torch.cat(dirs, dim=-2)                                    # (B, K, D0, 3)

    cv1 = _bf(v1 - c1[..., None])
    cv2 = _bf(v2 - c2[..., None])
    dc = c1 - c2

    def sep_sel(ds):
        return _sep_sel(ds, cv1, cv2, dc)

    def take(x, k):
        return torch.gather(x, -2, k[..., None, None].expand(k.shape + (1, 3)))[..., 0, :]

    seps = sep_sel(dirs)
    k = torch.argmin(seps, dim=-1)
    n = take(dirs, k)
    s_best = torch.gather(seps, -1, k[..., None])[..., 0]

    ring = torch.as_tensor(ring_np(), device=dev)
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=f32, device=dev)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=f32, device=dev)
    for radius in RING_RADII:
        helper = torch.where((torch.abs(n[..., 0]) < 0.5)[..., None], ex, ey)
        t1v = cross(n, helper)
        t1v = t1v / (_norm(t1v, keepdim=True) + 1e-12)
        t2v = cross(n, t1v)
        cand = n[..., None, :] + radius * (
            ring[:, :1] * t1v[..., None, :] + ring[:, 1:] * t2v[..., None, :]
        )
        cand = cand / (_norm(cand, keepdim=True) + 1e-12)
        ss = sep_sel(cand)
        kk = torch.argmin(ss, dim=-1)
        s_cand = torch.gather(ss, -1, kk[..., None])[..., 0]
        better = s_cand < s_best
        n = torch.where(better[..., None], take(cand, kk), n)
        s_best = torch.where(better, s_cand, s_best)

    def extract(cv, v, neg):
        dots = _bf_dots(_bf(n)[..., None, :], cv)[..., 0, :]          # (B, K, V)
        if neg:
            dots = -dots
        dmax = torch.max(dots, dim=-1, keepdim=True).values
        oh = (dots >= dmax).to(f32)
        oh = oh / torch.sum(oh, dim=-1, keepdim=True)
        return torch.sum(oh[..., None, :] * v, dim=-1)

    p1 = extract(cv1, v1, False)
    p2 = extract(cv2, v2, True)
    dist = -_dot3(n, p1 - p2)
    return dist, 0.5 * (p1 + p2), n, p2


def hull_pair_plain(v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd, DX: int):
    """Plain version of the hull-pair kernel: (dist (B, K), pos (B, K, 3),
    n (B, K, 3), p2 (B, K, 3))."""
    return hull_pair_world_plain(world_from_loc(v1l, xm1, xp1), world_from_loc(v2l, xm2, xp2),
                                 c1, c2, xd, DX)


def hull_manifold_world_plain(v1, v2, c1, c2, xd, DX: int):
    """Plain version of the world-vertex manifold kernel on world verts
    (B, K, 3, V): (dist4 (B, K, 4), pos4 (B, K, 4, 3), n (B, K, 3))."""
    dev, f32 = v1.device, v1.dtype
    dist0, pos0, n, plane_pt = hull_pair_world_plain(v1, v2, c1, c2, xd, DX)
    corners = v1.transpose(-1, -2)                                    # (B, K, V1, 3)
    cdist = _dot3(corners - plane_pt[..., None, :], (-n)[..., None, :])

    ex = torch.tensor([1.0, 0.0, 0.0], dtype=f32, device=dev)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=f32, device=dev)
    helper = torch.where((torch.abs(n[..., 0]) < 0.5)[..., None], ex, ey)
    t1v = cross(n, helper)
    t1v = t1v / (_norm(t1v, keepdim=True) + 1e-24)
    t2v = cross(n, t1v)
    tdirs = torch.stack([t1v, -t1v, t2v, -t2v], dim=-2)              # (B, K, 4, 3)

    cv2 = _bf(v2 - c2[..., None])
    bounds = torch.max(_bf_dots(_bf(tdirs), cv2), dim=-1).values + _dot3(tdirs, c2[..., None, :])
    proj = _dot3(corners[..., :, None, :], tdirs[..., None, :, :])   # (B, K, V1, 4)
    ok = torch.all(proj <= bounds[..., None, :] + MANIFOLD_TOL, dim=-1)
    cdist = torch.where(ok, cdist, torch.full_like(cdist, BIG))

    # the 4 deepest; ties go to the lower corner index, as lax.top_k does
    sel = torch.sort(cdist, dim=-1, stable=True).indices[..., :4]
    dist4 = torch.gather(cdist, -1, sel)
    pos4 = torch.gather(corners, -2, sel[..., None].expand(sel.shape + (3,)))
    pos4 = pos4 - (0.5 * dist4)[..., None] * n[..., None, :]
    use_fb = dist4[..., 3] >= BIG / 2
    dist4 = torch.cat([dist4[..., :3], torch.where(use_fb, dist0, dist4[..., 3])[..., None]], -1)
    pos4 = torch.cat([pos4[..., :3, :],
                      torch.where(use_fb[..., None], pos0, pos4[..., 3, :])[..., None, :]], -2)
    return dist4, pos4, n


def hull_manifold_plain(v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd, DX: int):
    """Plain version of the manifold kernel: (dist4 (B, K, 4),
    pos4 (B, K, 4, 3), n (B, K, 3))."""
    return hull_manifold_world_plain(world_from_loc(v1l, xm1, xp1),
                                     world_from_loc(v2l, xm2, xp2), c1, c2, xd, DX)


# ---------------------------------------------------------------------------
# wrappers: a CPU tensor takes the plain version, a CUDA tensor the kernel
# ---------------------------------------------------------------------------


def _check(args, world: bool):
    """Validate the operands of a hull kernel: local sides (v, xm, xp) or,
    for the world entries, world verts alone; returns (B, K, V1, V2)."""
    v1, v2 = args[0], args[1 if world else 3]
    B, K = v1.shape[:2]
    V1, V2 = v1.shape[-1], v2.shape[-1]
    side1 = [(B, K, 3, V1)] if world else [(B, K, 3, V1), (B, K, 9), (B, K, 3)]
    side2 = [(B, K, 3, V2)] if world else [(B, K, 3, V2), (B, K, 9), (B, K, 3)]
    shapes = side1 + side2 + [(B, K, 3), (B, K, 3), (B, K) + tuple(args[-1].shape[2:3]) + (3,)]
    if len(args) != len(shapes):
        raise ValueError(f"hull kernel takes {len(shapes)} operands, got {len(args)}")
    for a, s in zip(args, shapes):
        if tuple(a.shape) != s or a.dtype != torch.float32 or not a.is_contiguous():
            raise ValueError(f"hull kernel operand {tuple(a.shape)} {a.dtype}, "
                             f"want {s} float32 contiguous")
        if a.device != v1.device:
            raise ValueError("hull kernel operands on different devices")
    if not (1 <= V1 <= MAX_VERTS and 1 <= V2 <= MAX_VERTS):
        raise ValueError(f"hull kernels take 1 to {MAX_VERTS} verts a side, got {V1}, {V2}")
    return B, K, V1, V2


@functools.lru_cache(maxsize=8)
def _dir_table(device: str) -> torch.Tensor:
    """The kernels' direction table: the 12 icosahedron directions, then the
    ring's (cos, sin) pairs."""
    tab = np.concatenate([dirs12_np().reshape(-1), ring_np().reshape(-1)]).astype(np.float32)
    return torch.as_tensor(tab, device=device)


def _launch_pair(name, args, DX):
    from robogym_torch import cuda

    B, K, V1, V2 = _check(args, world=name.endswith("_world"))
    dev = args[0].device
    dist = torch.empty((B, K), dtype=torch.float32, device=dev)
    pos = torch.empty((B, K, 3), dtype=torch.float32, device=dev)
    n = torch.empty_like(pos)
    p2 = torch.empty_like(pos)
    cuda.launch(name, *args, _dir_table(str(dev)), dist, pos, n, p2,
                B * K, V1, V2, args[-1].shape[2], DX)
    return dist, pos, n, p2


def _launch_manifold(name, args, DX):
    from robogym_torch import cuda

    B, K, V1, V2 = _check(args, world=name.endswith("_world"))
    if V1 < 4:
        raise ValueError(f"the hull manifold takes at least 4 side-1 verts, got {V1}")
    dev = args[0].device
    dist4 = torch.empty((B, K, 4), dtype=torch.float32, device=dev)
    pos4 = torch.empty((B, K, 4, 3), dtype=torch.float32, device=dev)
    n = torch.empty((B, K, 3), dtype=torch.float32, device=dev)
    cuda.launch(name, *args, _dir_table(str(dev)), dist4, pos4, n,
                B * K, V1, V2, args[-1].shape[2], DX)
    return dist4, pos4, n


def hull_pair(v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd, DX: int):
    """Single-point hull-hull collision on local verts and poses (kernel D
    on CUDA tensors)."""
    if v1l.device.type == "cpu":
        return hull_pair_plain(v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd, DX)
    return _launch_pair("hull_pair", (v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd), DX)


def hull_pair_world(v1, v2, c1, c2, xd, DX: int):
    """Single-point hull-hull collision on world verts (kernel G on CUDA
    tensors); the counterpart of `_make_hull_core(DX)`."""
    if v1.device.type == "cpu":
        return hull_pair_world_plain(v1, v2, c1, c2, xd, DX)
    return _launch_pair("hull_pair_world", (v1, v2, c1, c2, xd), DX)


def hull_manifold(v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd, DX: int):
    """4-point hull manifold on local verts and poses (kernel C on CUDA
    tensors)."""
    if v1l.device.type == "cpu":
        return hull_manifold_plain(v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd, DX)
    return _launch_manifold("hull_manifold", (v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd), DX)


def hull_manifold_world(v1, v2, c1, c2, xd, DX: int):
    """4-point hull manifold on world verts (kernel H on CUDA tensors); the
    counterpart of `_make_hull_manifold_core(DX)`."""
    if v1.device.type == "cpu":
        return hull_manifold_world_plain(v1, v2, c1, c2, xd, DX)
    return _launch_manifold("hull_manifold_world", (v1, v2, c1, c2, xd), DX)
