"""The box-box contact manifold: SAT over 15 axes picks the normal; the 17
candidates are the 8 corners of box 2 inside box 1, the 8 corners of box 1
inside box 2, and the SAT witness point.

Counterpart of `robogym_tpu/physics/collision/boxbox_kernel.py`
(`_boxbox_kernel`). `boxbox` is the wrapper: on CUDA tensors it launches the
hand-written kernel in `robogym_torch/csrc/boxbox.cu` (one thread per env
and pair); on CPU tensors it runs `boxbox_plain`, the PyTorch transcription
of the Pallas kernel's arithmetic.

That arithmetic differs from the JAX package's `primitives.box_box` (which
its collision driver runs off the TPU) on exact ties of the SAT
depth: the primitive ramps the depths by 1e-7 per axis and, if a tie
survives the ramp, averages the tied axes; the kernel keeps a running
strict minimum in axis order, so the first tied axis wins. A block resting
flat on the table ties its z axis with the table's, and there the two give
normals that agree only after the orientation flip. `boxbox_plain` follows
the kernel, operation for operation and in the same order, so that the CUDA
kernel (built with `-fmad=false`) reproduces it to the last bit on most
inputs.

Shapes (batch-major, leading B and K pairs): centres xp (B, K, 3), rotations
xm (B, K, 3, 3), half-sizes s (B, K, 3). Returns dist (B, K, 17), pos
(B, K, 17, 3) and the normal broadcast to (B, K, 17, 3).
"""

from __future__ import annotations

import torch

BIG = 1e10
NCAND = 17
_CORNER_SIGNS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]


def _dot(u, v):
    return u[0] * v[0] + u[1] * v[1] + u[2] * v[2]


def _cross(u, v):
    return (u[1] * v[2] - u[2] * v[1], u[2] * v[0] - u[0] * v[2], u[0] * v[1] - u[1] * v[0])


def _frames(xp1, xm1, s1, xp2, xm2, s2):
    """Each box's world axes and half-sizes and the offset t = xp2 - xp1,
    as tuples of (B, K) components."""
    a1 = [tuple(xm1[..., r, i] for r in range(3)) for i in range(3)]     # world axis i of box 1
    a2 = [tuple(xm2[..., r, i] for r in range(3)) for i in range(3)]
    t = tuple(xp2[..., i] - xp1[..., i] for i in range(3))
    return a1, [s1[..., i] for i in range(3)], a2, [s2[..., i] for i in range(3)], t


def _depth(ax, frames):
    """Overlap of the two boxes' projections on axis `ax`."""
    a1, s1c, a2, s2c, t = frames
    p1 = torch.abs(_dot(ax, a1[0])) * s1c[0] + torch.abs(_dot(ax, a1[1])) * s1c[1] \
        + torch.abs(_dot(ax, a1[2])) * s1c[2]
    p2 = torch.abs(_dot(ax, a2[0])) * s2c[0] + torch.abs(_dot(ax, a2[1])) * s2c[1] \
        + torch.abs(_dot(ax, a2[2])) * s2c[2]
    return p1 + p2 - torch.abs(_dot(ax, t))


def _sat_normal(frames):
    """SAT over the 15 axes with a running strict minimum in axis order.
    Returns (SAT depth, unit normal from box 1 to box 2)."""
    a1, _, a2, _, t = frames
    best = None
    for ax in a1 + a2:
        d = _depth(ax, frames)
        if best is None:
            best = (d,) + ax
        else:
            take = d < best[0]
            best = tuple(torch.where(take, new, old) for new, old in zip((d,) + ax, best))
    for i in range(3):
        for j in range(3):
            cx = _cross(a1[i], a2[j])
            nrm2 = _dot(cx, cx)
            inv = 1.0 / torch.sqrt(nrm2 + 1e-18)
            ax = (cx[0] * inv, cx[1] * inv, cx[2] * inv)
            d = torch.where(nrm2 > 1e-12, _depth(ax, frames), torch.full_like(nrm2, BIG))
            take = d < best[0]
            best = tuple(torch.where(take, new, old) for new, old in zip((d,) + ax, best))
    sat_depth, n0, n1, n2 = best
    inv = 1.0 / torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2 + 1e-24)
    n0, n1, n2 = n0 * inv, n1 * inv, n2 * inv
    flip = torch.where(_dot((n0, n1, n2), t) < 0, -1.0, 1.0)
    return sat_depth, (n0 * flip, n1 * flip, n2 * flip)


def _witness(frames, xp1c, xp2c, n):
    """The SAT witness point: the midpoint of box 1's support along n and
    box 2's along -n, with signs dead-banded at 1e-6 (B, K, 3)."""
    a1, s1c, a2, s2c, _ = frames

    def dsign(x):
        return torch.where(torch.abs(x) > 1e-6, torch.sign(x), torch.zeros_like(x))

    def support(xp, ax, s, direction):
        w = [dsign(_dot(ax[k], direction)) * s[k] for k in range(3)]
        return [xp[i] + ((w[0] * ax[0][i] + w[1] * ax[1][i]) + w[2] * ax[2][i]) for i in range(3)]

    sup1 = support(xp1c, a1, s1c, n)
    sup2 = support(xp2c, a2, s2c, (-n[0], -n[1], -n[2]))
    return torch.stack([0.5 * (sup1[i] + sup2[i]) for i in range(3)], -1)


def _candidates(frames, xp1, xp2, sat_depth, n):
    """The 17 candidates (dist (B, K, 17), pos (B, K, 17, 3)) for a chosen
    normal n and SAT depth."""
    a1, s1c, a2, s2c, _ = frames
    xp1c = [xp1[..., i] for i in range(3)]
    xp2c = [xp2[..., i] for i in range(3)]

    def corner_candidates(xp_a, a_ax, s_a, xp_b, b_ax, s_b, sign):
        dists, poss = [], []
        for sgn in _CORNER_SIGNS:
            corner = [xp_b[i] + ((sgn[0] * s_b[0] * b_ax[0][i] + sgn[1] * s_b[1] * b_ax[1][i])
                                 + sgn[2] * s_b[2] * b_ax[2][i]) for i in range(3)]
            rel = [corner[i] - xp_a[i] for i in range(3)]
            over = [torch.abs(_dot(rel, a_ax[k])) - s_a[k] for k in range(3)]
            dist = torch.maximum(torch.maximum(over[0], over[1]), over[2])
            inside = (over[0] < 1e-3) & (over[1] < 1e-3) & (over[2] < 1e-3)
            dist = torch.where(inside, dist, torch.full_like(dist, BIG))
            dists.append(dist)
            poss.append(torch.stack([corner[i] - 0.5 * dist * sign * n[i] for i in range(3)], -1))
        return dists, poss

    d2s, p2s = corner_candidates(xp1c, a1, s1c, xp2c, a2, s2c, 1.0)
    d1s, p1s = corner_candidates(xp2c, a2, s2c, xp1c, a1, s1c, -1.0)
    p_sat = _witness(frames, xp1c, xp2c, n)
    return torch.stack(d2s + d1s + [-sat_depth], -1), torch.stack(p2s + p1s + [p_sat], -2)


def boxbox_plain(xp1, xm1, s1, xp2, xm2, s2):
    """Plain version of the box-box kernel (`_boxbox_kernel`): the same
    arguments and returns as `boxbox`."""
    frames = _frames(xp1, xm1, s1, xp2, xm2, s2)
    sat_depth, n = _sat_normal(frames)
    dist, pos = _candidates(frames, xp1, xp2, sat_depth, n)
    return dist, pos, torch.stack(n, -1)[..., None, :].expand(pos.shape)


def along(xp1, xm1, s1, xp2, xm2, s2, normal):
    """What the plain version computes once it has picked a given unit
    normal (B, K, 3): the SAT depth along it (B, K), and the candidates
    dist (B, K, 17) and pos (B, K, 17, 3) for it."""
    frames = _frames(xp1, xm1, s1, xp2, xm2, s2)
    n = tuple(normal[..., i] for i in range(3))
    depth = _depth(n, frames)
    return (depth,) + _candidates(frames, xp1, xp2, depth, n)


def boxbox(xp1, xm1, s1, xp2, xm2, s2):
    """The box-box manifold of K pairs per env; the CUDA kernel on CUDA
    tensors."""
    if xp1.device.type == "cpu":
        return boxbox_plain(xp1, xm1, s1, xp2, xm2, s2)
    from robogym_torch import cuda

    B, K = xp1.shape[:2]
    dev = xp1.device
    ops = [("xp1", xp1, (B, K, 3)), ("xm1", xm1, (B, K, 3, 3)), ("s1", s1, (B, K, 3)),
           ("xp2", xp2, (B, K, 3)), ("xm2", xm2, (B, K, 3, 3)), ("s2", s2, (B, K, 3))]
    args = []
    for name, t, shape in ops:
        if tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev:
            raise ValueError(f"boxbox operand {name}: {tuple(t.shape)} {t.dtype} {t.device}, "
                             f"want a {shape} float32 tensor on {dev}")
        args.append(t.contiguous())
    dist = torch.empty((B, K, NCAND), dtype=torch.float32, device=dev)
    pos = torch.empty((B, K, NCAND, 3), dtype=torch.float32, device=dev)
    normal = torch.empty((B, K, 3), dtype=torch.float32, device=dev)
    cuda.launch("boxbox", *args, dist, pos, normal, B * K)
    return dist, pos, normal[..., None, :].expand(pos.shape)
