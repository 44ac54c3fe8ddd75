"""The convex narrowphase of pairs with a round geom, against the JAX
package's.

`convex.support_multi` against the JAX driver's `_support_multi` for every
convex type, and the driver's `_collide_round_group` against the JAX
driver's `_collide_convex_group`, both under `jax.jit` (the JAX env runs
them jitted, and XLA then rounds the mesh's bf16 dots once, after the
float32 sum of exact products), on seeded pairs posed near contact: some
apart, some overlapping.

Where both packages pick the same direction (normals within 1e-5), dist,
pos and normal agree to 1e-5 (pos along the normal only where the normal
is a box's face normal, whose support is then any corner of the face). A
mesh's support vertex is picked by bf16
dots, so two packages whose world verts differ in their last float32 bit
may pick other directions on a tie; there both answers must be valid
witnesses: unit normals, each `dist` minus the exact separation of the two
shapes along its own normal (float64 supports) within WITNESS_REL times the
mesh's radius, and the two depths within that plus the last ring's angular
step of each other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogym_torch.mjcf.model import GeomType
from robogym_torch.physics.collision import convex as t_cvx
from robogym_torch.physics.collision import driver as t_driver
from robogym_tpu.physics.collision import driver as j_driver

K = 48
V = 64
TOL = 1e-5
# A mesh's support vertex is picked by bf16 dots of verts centred on the
# mesh (relative rounding 2^-8): a pick may be off by twice that of the
# mesh's radius.
WITNESS_REL = 2 * 2.0 ** -8
# The last ring searches 0.08 rad about the incumbent: a depth may miss the
# best direction's by about 1 - cos(0.08) of the pair's size.
RING_BOUND = 1.0 - np.cos(0.08)

TYPES = {"sphere": GeomType.SPHERE, "capsule": GeomType.CAPSULE, "cylinder": GeomType.CYLINDER,
         "ellipsoid": GeomType.ELLIPSOID, "box": GeomType.BOX, "mesh": GeomType.MESH}


def _rotations(rng, n):
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
        np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
        np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
    ], 1).astype(np.float32)


def _side(rng, kind, n, pos):
    """A side's data dict (numpy, (n, ...)) as the drivers gather it: a
    mesh's padded local verts (3, V) parked at its local centre, with fewer
    than V real verts in some hulls."""
    xmat = _rotations(rng, n)
    size = rng.uniform(0.015, 0.04, (n, 3)).astype(np.float32)
    data = dict(xpos=pos.astype(np.float32), xmat=xmat, size=size)
    if kind != "mesh":
        data["center"] = data["xpos"]
        return data, np.linalg.norm(size, axis=-1)
    vloc = np.zeros((n, 3, V), np.float32)
    cloc = rng.uniform(-0.005, 0.005, (n, 3)).astype(np.float32)
    for i in range(n):
        nv = int(rng.integers(12, V + 1))
        pts = rng.normal(size=(nv, 3)) * rng.uniform(0.01, 0.035, 3)
        vloc[i, :, :nv] = (pts + cloc[i]).T
        vloc[i, :, nv:] = cloc[i][:, None]
    data["vloc"] = vloc
    data["center"] = (pos + np.einsum("kij,kj->ki", xmat, cloc)).astype(np.float32)
    radius = np.linalg.norm(vloc - cloc[:, :, None], axis=1).max(-1)
    return data, radius


def _pairs(t1, t2, seed):
    rng = np.random.default_rng(seed)
    c1 = rng.uniform(-0.1, 0.1, (K, 3))
    u = rng.normal(size=(K, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    c2 = c1 + u * rng.uniform(0.02, 0.08, (K, 1))
    d1, r1 = _side(rng, t1, K, c1)
    d2, r2 = _side(rng, t2, K, c2)
    return d1, d2, r1, r2


def _jax(data):
    return {k: jnp.asarray(v) for k, v in data.items()}


def _torch(data):
    return {k: torch.as_tensor(v)[None] for k, v in data.items()}


@pytest.mark.parametrize("kind", list(TYPES))
def test_support_multi_matches_jax(kind):
    """Every type's batched support on 25 directions a pair (12 shared, the
    centre line, a box's six face normals and six random ones), to 1e-6.
    For meshes the pick is by bf16 dots: where the two packages' float32
    world verts make another vertex win a tie, the supports differ by a
    vertex of equal bf16 dot, so they are held to the dot instead."""
    rng = np.random.default_rng(list(TYPES).index(kind))
    data, radius = _side(rng, kind, K, rng.uniform(-0.1, 0.1, (K, 3)))
    dirs = rng.normal(size=(K, 25, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = np.asarray(jax.jit(lambda d, x: j_driver._support_multi(TYPES[kind], d, x))(
        _jax(data), jnp.asarray(dirs)))
    got = t_cvx.support_multi(TYPES[kind], _torch(data), torch.as_tensor(dirs)[None])[0].numpy()
    if kind != "mesh":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        return
    same = np.abs(got - want).max(-1) <= 1e-6
    assert same.mean() > 0.95, same.mean()
    dots = lambda p: np.einsum("kdi,kdi->kd", dirs, p)
    np.testing.assert_allclose(dots(got), dots(want), rtol=0,
                               atol=float(WITNESS_REL * radius.max()))


def _exact_support(kind, data, n):
    """Float64 support points (K, 3) along unit directions n (K, 3)."""
    d = {k: v.astype(np.float64) for k, v in data.items()}
    xpos, xmat, size = d["xpos"], d["xmat"], d["size"]
    if kind == "mesh":
        wv = xpos[:, :, None] + np.einsum("kij,kjv->kiv", xmat, d["vloc"])
        return np.take_along_axis(wv, np.argmax(np.einsum("ki,kiv->kv", n, wv), -1)[:, None, None]
                                  .repeat(3, 1), 2)[..., 0]
    local = np.einsum("kij,ki->kj", xmat, n)
    if kind == "box":
        return xpos + np.einsum("kij,kj->ki", xmat, np.sign(local) * size)
    if kind == "sphere":
        return xpos + n * size[:, :1]
    if kind == "ellipsoid":
        v = size ** 2 * local / np.linalg.norm(size * local, axis=-1, keepdims=True)
        return xpos + np.einsum("kij,kj->ki", xmat, v)
    axis = xmat[:, :, 2]
    ax = np.sum(axis * n, -1, keepdims=True)
    out = xpos + np.sign(ax) * axis * size[:, 1:2]
    if kind == "capsule":
        return out + n * size[:, :1]
    radial = n - ax * axis
    return out + radial / np.linalg.norm(radial, axis=-1, keepdims=True) * size[:, :1]


ROUND_PAIRS = [("sphere", "mesh"), ("capsule", "mesh"), ("cylinder", "box"),
               ("cylinder", "mesh"), ("ellipsoid", "box"), ("ellipsoid", "mesh")]


@pytest.mark.parametrize("t1,t2", ROUND_PAIRS)
def test_round_branch_matches_jax(t1, t2):
    """`_collide_round_group` against the JAX `_collide_convex_group` on 48
    seeded pairs: equal where the normals agree, valid witnesses where a
    bf16 mesh tie parts them (module docstring)."""
    d1, d2, r1, r2 = _pairs(t1, t2, ROUND_PAIRS.index((t1, t2)))
    want = [np.asarray(x) for x in jax.jit(
        lambda a, b: j_driver._collide_convex_group(TYPES[t1], TYPES[t2], a, b))(
            _jax(d1), _jax(d2))]
    got = [x[0].numpy() for x in t_driver._collide_round_group(TYPES[t1], TYPES[t2],
                                                                _torch(d1), _torch(d2))]
    same = np.abs(got[2] - want[2]).max(-1) <= TOL
    assert same.mean() > 0.8, same.mean()
    for g, w in zip(got[::2], want[::2]):
        np.testing.assert_allclose(g[same], w[same], rtol=0, atol=TOL)
    # along a box's face normal its support is any corner of that face,
    # picked by the sign of float32 noise: there pos is held along n only
    flat = np.zeros(K, bool)
    for kind, data in ((t1, d1), (t2, d2)):
        if kind == "box":
            flat |= np.abs(np.einsum("kij,ki->kj", data["xmat"], want[2])).min(-1) < 1e-5
    np.testing.assert_allclose(got[1][same & ~flat], want[1][same & ~flat], rtol=0, atol=TOL)
    along = lambda pos: np.einsum("ki,ki->k", pos, want[2])
    np.testing.assert_allclose(along(got[1])[same], along(want[1])[same], rtol=0, atol=TOL)
    overlapping = 0
    for k in np.nonzero(~same)[0]:
        tol = WITNESS_REL * (r1[k] + r2[k]) + RING_BOUND * (r1[k] + r2[k])
        for dist, _, n in (got, want):
            nk = n[k].astype(np.float64)
            assert abs(np.linalg.norm(nk) - 1.0) <= 1e-5
            sel = lambda x: {kk: v[k:k + 1] for kk, v in x.items()}
            sep = np.dot(nk, _exact_support(t2, sel(d2), -nk[None])[0]
                         - _exact_support(t1, sel(d1), nk[None])[0])
            assert abs(dist[k] - sep) <= WITNESS_REL * (r1[k] + r2[k]), (dist[k], sep)
        assert abs(got[0][k] - want[0][k]) <= tol, (got[0][k], want[0][k], tol)
    overlapping = (want[0] < 0).sum()
    assert overlapping and (want[0] > 0).sum(), overlapping
