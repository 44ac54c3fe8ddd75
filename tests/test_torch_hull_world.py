"""Kernels G and H of the port, the hull kernels on world verts: their plain
versions (`hull_pair_world_plain`, `hull_manifold_world_plain`) against the
JAX package's entry points `_make_hull_core(0)` and
`_make_hull_manifold_core(6)` on the cases of tests/test_convex_kernel.py,
with JAX run through its XLA reference (its CPU default) and through its
Pallas kernel in interpret mode; the world entries against the local ones
bit for bit on the CPU; and, on a machine with an NVIDIA GPU, the CUDA
kernels against their plain versions and against C and D.

JAX is imported inside the tests that compare with it: the card's machine
has none, and runs the `cuda` test with
`python -m pytest tests/test_torch_hull_world.py --noconftest -m cuda`."""

import contextlib
import os

import numpy as np
import pytest
import torch

import chip_smoke
from _torch_common import hull_inputs, locked_like_model, locked_like_state, settle_state
from robogym_torch.physics import step as t_step
from robogym_torch.physics.collision import convex_kernel as t_ck
from robogym_torch.worlds import table_setting_like

B, K = 4, 5
EYE6 = np.concatenate([np.eye(3), -np.eye(3)]).astype(np.float32)


def _cube_verts(center, half):
    signs = np.asarray([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                       np.float32)
    return (center[None] + signs * half).T                           # (3, 8)


def _random_hulls(rng, V):
    v = (rng.standard_normal((B, K, 3, V)) * 0.05
         + rng.standard_normal((B, K, 3, 1)) * 0.08).astype(np.float32)
    return v, v.mean(-1)


def _boxes(rng):
    centers = (rng.standard_normal((B, K, 3)) * 0.05).astype(np.float32)
    halfs = (0.02 + rng.random((B, K, 3)) * 0.04).astype(np.float32)
    v = np.stack([np.stack([_cube_verts(centers[b, k], halfs[b, k]) for k in range(K)])
                  for b in range(B)])
    return v, centers


def _single(v1, c1, v2, c2):
    return (np.asarray(v1, np.float32)[None, None], np.asarray(c1, np.float32)[None, None],
            np.asarray(v2, np.float32)[None, None], np.asarray(c2, np.float32)[None, None])


def _case(name, manifold):
    """World operands (v1, v2, c1, c2) of a case of tests/test_convex_kernel.py:
    random hulls (for the manifold, axis-aligned boxes against random hulls)
    at V=16 or V=64, two unit cubes overlapping by 0.1 along x, a unit cube
    1 cm deep in a large slab, two unit cubes 0.3 apart."""
    if name.startswith("random"):
        V = int(name[len("random"):])
        rng = np.random.default_rng(3 if not manifold else 7)
        v1, c1 = _boxes(rng) if manifold else _random_hulls(rng, V)
        v2, c2 = _random_hulls(rng, V)
    else:
        zero = np.zeros(3, np.float32)
        v1, c1, v2, c2 = {
            "overlap": _single(_cube_verts(zero, 0.5), zero,
                               _cube_verts(np.asarray([0.9, 0, 0]), 0.5), [0.9, 0, 0]),
            "slab": _single(_cube_verts(np.asarray([0, 0, 0.49]), 0.5), [0, 0, 0.49],
                            _cube_verts(np.asarray([0, 0, -1.0]), np.asarray([2.0, 2.0, 1.0])),
                            [0, 0, -1.0]),
            "separated": _single(_cube_verts(zero, 0.5), zero,
                                 _cube_verts(np.asarray([1.3, 0, 0]), 0.5), [1.3, 0, 0]),
        }[name]
    return tuple(np.ascontiguousarray(a, np.float32) for a in (v1, v2, c1, c2))


def _xd(c1, DX):
    """Extra directions: the +-x, +-y, +-z face normals for DX=6, else one
    unused zero row."""
    rows = EYE6 if DX else np.zeros((1, 3), np.float32)
    return np.broadcast_to(rows, c1.shape[:-1] + rows.shape).copy()


@contextlib.contextmanager
def _pallas_interpret():
    from robogym_tpu.physics.collision import convex_kernel as j_ck

    old = j_ck.INTERPRET
    j_ck.INTERPRET = True
    os.environ["ROBOGYM_TPU_FORCE_PALLAS"] = "1"
    try:
        yield
    finally:
        j_ck.INTERPRET = old
        os.environ.pop("ROBOGYM_TPU_FORCE_PALLAS", None)


def _jax(manifold, args, DX, pallas):
    """The JAX package's world-vertex entry point on (v1, v2, c1, c2, xd),
    batched over B, through its XLA reference or its Pallas kernel."""
    import jax
    import jax.numpy as jnp
    from robogym_tpu.physics.collision import convex_kernel as j_ck

    core = (j_ck._make_hull_manifold_core if manifold else j_ck._make_hull_core)(DX)
    dirs12, ring = jnp.asarray(j_ck._dirs12_np()), jnp.asarray(j_ck._ring_np())
    fn = jax.jit(jax.vmap(core, in_axes=(0, 0, 0, 0, 0, None, None)))
    with _pallas_interpret() if pallas else contextlib.nullcontext():
        out = fn(*[jnp.asarray(a) for a in args], dirs12, ring)
    return [np.asarray(x, np.float64) for x in out]


def _assert_witnesses_valid(v1, v2, dist, n, p1, p2, tol=5e-3):
    """dist is the separation along n, p1 a support point of hull 1 along n,
    p2 one of hull 2 along -n (the check of tests/test_convex_kernel.py)."""
    d1 = np.einsum("i,iv->v", n, v1)
    d2 = np.einsum("i,iv->v", n, v2)
    assert abs(-(d1.max() - d2.min()) - dist) <= tol
    assert n @ p1 >= d1.max() - tol
    assert n @ p2 <= d2.min() + tol


CASES = ["random16", "random64", "overlap", "slab", "separated"]


def _assert_matches_reference(manifold, v1, v2, got, pair, want):
    """Against the XLA reference, whose arithmetic the port transcribes:
    where the chosen direction agrees, every output to 1e-5 (the manifold's
    positions where its depth is not the 1e10 sentinel); elsewhere, a
    near-tie of the bf16 selection, the port's witnesses must be supports of
    both hulls to 5e-3, at most 1 pair in 10."""
    same = np.abs(got[2] - want[2]).max(-1) <= 1e-6                     # (B, K)
    assert (~same).sum() <= same.size // 10, ((~same).sum(), same.size)
    if manifold:
        live = want[0] < 1e9
        np.testing.assert_array_equal((got[0] < 1e9)[same], live[same])
        np.testing.assert_allclose(got[0][same], want[0][same], rtol=0, atol=1e-5)
        slots = same[..., None] & live                                  # (B, K, 4)
        np.testing.assert_allclose(got[1][slots], want[1][slots], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[2][same], want[2][same], rtol=0, atol=1e-5)
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[same], w[same], rtol=0, atol=1e-5)
    for idx in zip(*np.nonzero(~same)):
        dist, pos, n, p2 = (x[idx] for x in pair)
        _assert_witnesses_valid(v1[idx], v2[idx], dist, n, 2.0 * pos - p2, p2)


def _assert_matches_kernel(manifold, v1, v2, got, pair, want):
    """Against the Pallas kernel, which rounds its bf16 dots otherwise than
    its reference (and than the port) and so, on near-ties, may pick another
    direction, other support verts or, for the manifold, other corners:
    tests/test_convex_kernel.py holds the kernel to its reference by the
    validity of its witnesses, and so this holds the port. Each pair either
    agrees with the kernel on every output to 1e-5 (the manifold's positions
    where the kernel's depth is not the sentinel), or the port's witnesses
    are supports of both hulls to 5e-3; at least two pairs in three agree
    (on the random cases 15 or 16 of 20 do)."""
    live = want[0] < 1e9 if manifold else None
    off = np.zeros(got[0].shape[:2], bool)
    for i, (g, w) in enumerate(zip(got, want)):
        d = np.abs(g - w)
        if manifold and i == 1:
            d = np.where(live[..., None], d, 0.0)
        off |= d.reshape(d.shape[0], d.shape[1], -1).max(-1) > 1e-5
    assert 3 * off.sum() <= off.size, (off.sum(), off.size)
    for idx in zip(*np.nonzero(off)):
        dist, pos, n, p2 = (x[idx] for x in pair)
        _assert_witnesses_valid(v1[idx], v2[idx], dist, n, 2.0 * pos - p2, p2)


@pytest.mark.parametrize("kernel", ["hull_pair_world", "hull_manifold_world"])
@pytest.mark.parametrize("case", CASES)
def test_world_plain_matches_jax(kernel, case):
    """G (`hull_pair_world_plain`, DX=0) and H (`hull_manifold_world_plain`,
    DX=6, the +-x, +-y, +-z face normals) against `_make_hull_core(0)` and
    `_make_hull_manifold_core(6)` through the XLA reference
    (`_assert_matches_reference`) and through the Pallas kernel in
    interpret mode (`_assert_matches_kernel`). On the cube cases, the depth
    of tests/test_convex_kernel.py: overlap -0.1, slab -0.01 (all four
    manifold slots), separated 0.3, to 5e-3."""
    manifold = kernel == "hull_manifold_world"
    DX = 6 if manifold else 0
    v1, v2, c1, c2 = _case(case, manifold)
    targs = [torch.as_tensor(a) for a in (v1, v2, c1, c2, _xd(c1, DX))]
    got = [x.numpy().astype(np.float64) for x in getattr(t_ck, kernel + "_plain")(*targs, DX)]
    pair = [x.numpy() for x in t_ck.hull_pair_world_plain(*targs, DX)]
    jargs = [a.numpy() for a in targs]
    _assert_matches_reference(manifold, v1, v2, got, pair, _jax(manifold, jargs, DX, False))
    _assert_matches_kernel(manifold, v1, v2, got, pair, _jax(manifold, jargs, DX, True))
    if case in ("overlap", "slab", "separated"):
        d = got[0][0, 0]
        expect = {"overlap": -0.1, "slab": -0.01, "separated": 0.3}[case]
        assert np.all(np.abs(d - expect) <= 5e-3), (case, d)


def _table_manifold_calls():
    """The operands of the table world's two `hull_manifold` calls in one
    substep at B=4 (40 substeps after the start): the box-mesh group (side 1
    the table's 8 corners, DX=6) and the mesh-mesh group (V1=V2=64, DX=0),
    each as ((v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd), DX)."""
    tm, d = settle_state(B, world=table_setting_like)
    calls = chip_smoke.capture_calls(t_ck, "hull_manifold", lambda: t_step.fwd_position(tm, d))
    assert [c[0].shape[-1] for c in calls] == [8, 64]
    return [(c[:-1], c[-1]) for c in calls]


def test_table_world_manifold_matches_jax():
    """H (and so C, which is H after `world_from_loc`) on the table world's
    winners placed in the world, against `_make_hull_manifold_core(DX)`
    through the XLA reference, as `_assert_matches_reference` holds it: the
    box-mesh pairs at V1=8 and the mesh-mesh pairs at V1=V2=64, the plate's
    rim and the spoon among them. (The Pallas kernel unrolls its corner
    selection over all V1 corners; at V1=64 its interpret mode takes XLA:CPU
    more than ten minutes to compile.)"""
    for args, DX in _table_manifold_calls():
        v1, v2, c1, c2, xd = chip_smoke.to_world(args)
        got = [x.numpy().astype(np.float64) for x in t_ck.hull_manifold_world_plain(
            v1, v2, c1, c2, xd, DX)]
        pair = [x.numpy() for x in t_ck.hull_pair_world_plain(v1, v2, c1, c2, xd, DX)]
        jargs = [a.numpy() for a in (v1, v2, c1, c2, xd)]
        _assert_matches_reference(True, jargs[0], jargs[1], got, pair, _jax(True, jargs, DX, False))


@pytest.mark.parametrize("kernel", ["hull_pair", "hull_manifold"])
def test_world_entry_equals_local_entry(kernel):
    """On the CPU, the world entry on `world_from_loc`'s verts equals the
    local entry bit for bit, on the hull winners of a locked-like substep
    and on the same pairs re-posed so that side 2 overlaps side 1."""
    tm = locked_like_model()
    args, DX = hull_inputs(tm, locked_like_state(tm, B, seed=0))[kernel]
    v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd = args
    shift = c1 + 0.02 - c2
    for case in (args, (v1l, xm1, xp1, v2l, xm2, xp2 + shift, c1, c2 + shift, xd)):
        local = getattr(t_ck, kernel)(*case, DX)
        world = getattr(t_ck, kernel + "_world")(t_ck.world_from_loc(*case[0:3]),
                                                 t_ck.world_from_loc(*case[3:6]), *case[6:], DX)
        for g, w in zip(world, local):
            assert torch.equal(g, w)


def test_world_wrappers_validate_operands():
    """A CUDA call's operands are checked before the launch: shape, dtype,
    contiguity, and at most 64 verts a side."""
    v1, v2, c1, c2 = (torch.as_tensor(a) for a in _case("random16", False))
    xd = torch.zeros(B, K, 1, 3)
    assert t_ck._check((v1, v2, c1, c2, xd), world=True) == (B, K, 16, 16)
    with pytest.raises(ValueError):
        t_ck._check((v1, v2, c1, c2), world=True)
    with pytest.raises(ValueError):
        t_ck._check((v1.double(), v2, c1, c2, xd), world=True)
    with pytest.raises(ValueError):
        t_ck._check((v1, v2.transpose(-1, -2), c1, c2, xd), world=True)
    wide = torch.zeros(B, K, 3, 65)
    with pytest.raises(ValueError):
        t_ck._check((wide, v2, c1, c2, xd), world=True)


@pytest.mark.cuda
def test_cuda_world_kernels_match_plain_versions():
    """G and H on the card against their plain versions (`hull_readings`:
    1e-5 where the directions agree, at most 1 in 100 near-ties) on the
    cases above; and on the winners of a locked-like substep and of a
    table-world substep (box-mesh and mesh-mesh), C, D, G and H against
    their plain versions and G and H against D and C bit for bit
    (`world_vs_local`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    for kernel in ("hull_pair_world", "hull_manifold_world"):
        DX = 6 if kernel == "hull_manifold_world" else 0
        for case in CASES:
            v1, v2, c1, c2 = _case(case, DX == 6)
            args = tuple(torch.as_tensor(a, device="cuda") for a in (v1, v2, c1, c2, _xd(c1, DX)))
            *_, failures = chip_smoke.hull_readings(kernel, args, DX)
            assert not failures, (kernel, case, failures)
    tm = locked_like_model()
    calls = list(hull_inputs(tm, locked_like_state(tm, B, seed=0)).items())
    calls += [("hull_manifold", c) for c in _table_manifold_calls()]
    for name, (args, DX) in calls:
        cargs = tuple(a.to("cuda") for a in args)
        for kernel, kargs in ((name, cargs), (name + "_world", chip_smoke.to_world(cargs))):
            *_, failures = chip_smoke.hull_readings(kernel, kargs, DX)
            assert not failures, (kernel, failures)
        diff, off = chip_smoke.world_vs_local(name, cargs, DX)
        assert off == 0, (name, diff, off)
