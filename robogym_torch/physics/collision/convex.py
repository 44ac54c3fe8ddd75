"""Support functions and fixed direction sets for the convex narrowphase.

Counterpart of the parts of `robogym_tpu/physics/collision/convex.py` that
the collision driver uses: the icosahedron direction set `DIRS12` (and the
42-direction set it extends to) and per-geom support functions, batched
over leading axes: `sup(direction (..., 3)) -> point (..., 3)`; and
`support_multi`, the JAX driver's `_support_multi`: each geom type's
support over a set of directions per pair, as the round-geom branch of the
convex narrowphase calls it.
"""

from __future__ import annotations

import numpy as np
import torch

from robogym_torch.mjcf.model import GeomType

BIG = 1e10

_phi = (1 + 5**0.5) / 2
_ico = np.array(
    [
        [-1, _phi, 0], [1, _phi, 0], [-1, -_phi, 0], [1, -_phi, 0],
        [0, -1, _phi], [0, 1, _phi], [0, -1, -_phi], [0, 1, -_phi],
        [_phi, 0, -1], [_phi, 0, 1], [-_phi, 0, -1], [-_phi, 0, 1],
    ]
)
_mid = [
    (_ico[i] + _ico[j]) / 2
    for i in range(len(_ico)) for j in range(i + 1, len(_ico))
    if np.dot(_ico[i], _ico[j]) > 0.5
]
_dirs = np.concatenate([_ico, np.asarray(_mid).reshape(-1, 3)], axis=0)
DIRS42 = (_dirs / np.linalg.norm(_dirs, axis=1, keepdims=True)).astype(np.float32)
DIRS12 = (_ico / np.linalg.norm(_ico, axis=1, keepdims=True)).astype(np.float32)


def _dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _norm(a):
    return torch.sqrt(_dot(a, a))


def support_hull(verts: torch.Tensor, mask: torch.Tensor, direction: torch.Tensor) -> torch.Tensor:
    """Masked support point of padded vertex sets (..., V, 3)."""
    dots = _dot(verts, direction[..., None, :])
    dots = torch.where(mask > 0, dots, torch.full_like(dots, -BIG))
    k = torch.argmax(dots, dim=-1, keepdim=True)
    verts = verts.expand(dots.shape + (3,))
    return torch.gather(verts, -2, k[..., None].expand(k.shape + (3,))).squeeze(-2)


def make_hull_support(xpos, xmat, verts_local, mask):
    world = xpos[..., None, :] + torch.matmul(verts_local, xmat.transpose(-1, -2))
    return lambda direction: support_hull(world, mask, direction)


def make_box_support(xpos, xmat, size):
    def sup(direction):
        local = torch.matmul(xmat.transpose(-1, -2), direction[..., None])[..., 0]
        return xpos + torch.matmul(xmat, (torch.sign(local) * size)[..., None])[..., 0]
    return sup


def make_sphere_support(xpos, r):
    return lambda d: xpos + d * (r / (_norm(d) + 1e-12))[..., None]


def make_capsule_support(xpos, xmat, size):
    r, hh = size[..., 0], size[..., 1]
    axis = xmat[..., :, 2]

    def sup(direction):
        nd = direction / (_norm(direction) + 1e-12)[..., None]
        s = torch.sign(_dot(axis, nd))
        return xpos + (s * hh)[..., None] * axis + nd * r[..., None]
    return sup


def make_cylinder_support(xpos, xmat, size):
    r, hh = size[..., 0], size[..., 1]
    axis = xmat[..., :, 2]

    def sup(direction):
        nd = direction / (_norm(direction) + 1e-12)[..., None]
        ax = _dot(axis, nd)
        radial = nd - ax[..., None] * axis
        rn = _norm(radial) + 1e-12
        return (xpos + (torch.sign(ax) * hh)[..., None] * axis
                + radial / rn[..., None] * r[..., None])
    return sup


def make_ellipsoid_support(xpos, xmat, size):
    def sup(direction):
        local = torch.matmul(xmat.transpose(-1, -2), direction[..., None])[..., 0]
        v = size * size * local
        v = v / (_norm(size * local) + 1e-12)[..., None]
        return xpos + torch.matmul(xmat, v[..., None])[..., 0]
    return sup


def _unit(d: torch.Tensor) -> torch.Tensor:
    return d / (torch.linalg.vector_norm(d, dim=-1, keepdim=True) + 1e-12)


def support_multi(gtype: int, data, dirs: torch.Tensor) -> torch.Tensor:
    """Support points (..., D, 3) of one pair side along directions
    `dirs` (..., D, 3); `data` as the collision driver gathers a side
    (xpos, xmat, size, and a mesh's local verts `vloc` and world
    `center`). A mesh picks its vertex by bfloat16 dots of the centred
    world verts (`convex_kernel` rounds them as the JAX package's jitted
    step does) and averages the verts of a tie, which is then the support
    point."""
    from robogym_torch.physics.collision import convex_kernel as ck

    xpos, xmat, size = data["xpos"], data["xmat"], data["size"]
    if gtype == GeomType.MESH:
        wv = xpos[..., :, None] + torch.matmul(xmat, data["vloc"])      # world verts (..., 3, V)
        cv = ck._bf(wv - data["center"][..., :, None])
        dots = ck._bf_dots(ck._bf(dirs), cv)                            # (..., D, V)
        onehot = (dots >= torch.max(dots, dim=-1, keepdim=True).values).to(wv.dtype)
        onehot = onehot / torch.sum(onehot, dim=-1, keepdim=True)
        return torch.sum(onehot[..., :, None, :] * wv[..., None, :, :], dim=-1)
    if gtype == GeomType.BOX:
        local = torch.sum(xmat[..., None, :, :] * dirs[..., :, :, None], dim=-2)
        corner = torch.sign(local) * size[..., None, :]
        return xpos[..., None, :] + torch.sum(xmat[..., None, :, :] * corner[..., :, None, :],
                                              dim=-1)
    if gtype == GeomType.SPHERE:
        return xpos[..., None, :] + _unit(dirs) * size[..., None, :1]
    if gtype in (GeomType.CAPSULE, GeomType.CYLINDER):
        n = _unit(dirs)
        axis = xmat[..., :, 2]
        ax = torch.sum(axis[..., None, :] * n, dim=-1)
        out = xpos[..., None, :] + torch.sign(ax)[..., None] * axis[..., None, :] \
            * size[..., None, 1:2]
        if gtype == GeomType.CAPSULE:
            return out + n * size[..., None, :1]
        radial = n - ax[..., None] * axis[..., None, :]
        rn = torch.linalg.vector_norm(radial, dim=-1, keepdim=True) + 1e-12
        return out + radial / rn * size[..., None, :1]
    if gtype == GeomType.ELLIPSOID:
        local = torch.sum(xmat[..., None, :, :] * dirs[..., :, :, None], dim=-2)
        v = size[..., None, :] ** 2 * local
        v = v / (torch.linalg.vector_norm(size[..., None, :] * local, dim=-1, keepdim=True)
                 + 1e-12)
        return xpos[..., None, :] + torch.sum(xmat[..., None, :, :] * v[..., :, None, :], dim=-1)
    raise NotImplementedError(f"support of geom type {gtype}")
