"""Kernels A-F of the port: each plain version against the JAX package's
reference on seeded inputs at the shapes of the worlds that run it (B=4),
and, on a machine with an NVIDIA GPU, each CUDA kernel against its plain
version. These tests hold the math that the CUDA kernels reproduce.

JAX is imported inside the tests that compare with it: the card's machine
has none, and runs the `cuda` test with
`python -m pytest tests/test_torch_kernels.py --noconftest -m cuda`."""

import numpy as np
import pytest
import torch

from _torch_common import (core_inputs, hand_state, hull_inputs, jax_boxbox_kernel,
                           locked_like_model, locked_like_state, settle_state)
from robogym_torch.physics import cg_kernel, constraint_batched, factor_kernel
from robogym_torch.physics import step as t_step
from robogym_torch.physics.collision import boxbox_kernel as t_bb
from robogym_torch.physics.collision import convex_kernel as t_ck

B = 4
QACC_PREV = 25   # position of qacc_prev among the fused core's arguments


@pytest.fixture(scope="module")
def world():
    tm = locked_like_model()
    return tm, locked_like_state(tm, B, seed=0)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _spd(rng, batch, V):
    X = rng.standard_normal((batch, V, V))
    return (X @ X.transpose(0, 2, 1) / V + 0.5 * np.eye(V)).astype(np.float32)


def test_spd_inverse_plain_matches_jax():
    """A: <= 1e-5 relative (float32 Cholesky inverses of a matrix whose
    condition number is about 10; the two packages factor in other orders)."""
    import jax
    import jax.numpy as jnp
    from robogym_tpu.physics import factor_kernel as j_fk

    A = _spd(np.random.default_rng(0), B, 30)
    want = jax.vmap(j_fk._spd_inverse_ref)(jnp.asarray(A))
    got = factor_kernel.spd_inverse_plain(torch.as_tensor(A))
    assert _rel(_np(got), want) <= 1e-5


@pytest.mark.parametrize("warm", ["finite", "nonfinite"])
def test_fused_core_plain_matches_jax(world, warm):
    """B: the plain core (both SPD inverses and the plain CG solve) against
    the JAX package's `_make_core(...).reference` on a settled contact
    state, with identical inputs: <= 1e-4 relative on qacc, efc_force,
    qvel_new and qacc_smooth. qfrc = J^T f is held to 1e-2: after 15
    iterations the CG has not converged, and its small row forces keep
    float32's last-bit noise (on this state the port's own float32 and
    float64 runs differ by 3e-3 there, the port and JAX by 1.6e-3).
    "nonfinite" puts NaN, inf and 1e10 into three envs' qacc_prev, where
    the warmstart must fall back to qacc_smooth as the JAX guard does."""
    import jax
    import jax.numpy as jnp
    from robogym_tpu.physics import constraint_batched as j_cb

    tm, d = world
    kind_s, iterations, nfacet, args = core_inputs(tm, d)
    if warm == "nonfinite":
        args = list(args)
        qacc_prev = args[QACC_PREV].clone()
        qacc_prev[0, 3], qacc_prev[1, 0], qacc_prev[2, 5] = float("nan"), float("inf"), 1e10
        args[QACC_PREV] = qacc_prev
    got = constraint_batched.reference(kind_s, iterations, nfacet, *args)
    core = j_cb._make_core(kind_s.tobytes(), iterations, nfacet, True, True)
    jargs = [jnp.asarray(_np(a)) for a in args]
    in_axes = [None if a.ndim == 0 or k == 6 else 0 for k, a in enumerate(jargs)]
    want = jax.jit(jax.vmap(core, in_axes=in_axes))(*jargs)
    tols = dict(qacc=1e-4, qfrc=1e-2, efc_force=1e-4, qvel_new=1e-4, qacc_smooth=1e-4)
    for (name, tol), g, w in zip(tols.items(), got, want):
        assert _rel(_np(g), w) <= tol, (name, _rel(_np(g), w))
    assert (_np(got[2]) != 0).any(), "no constraint force: the state has no live rows"


def _assert_witnesses_valid(v1, v2, dist, n, p1, p2, tol=5e-3):
    """The port's contact where it chose another direction than JAX (a
    near-tie of the bf16 selection): dist is the separation along its n,
    p1 a support point of hull 1 along n, p2 one of hull 2 along -n (the
    check of tests/test_convex_kernel.py)."""
    d1 = np.einsum("i,iv->v", n, v1)
    d2 = np.einsum("i,iv->v", n, v2)
    assert abs(-(d1.max() - d2.min()) - dist) <= tol
    assert n @ p1 >= d1.max() - tol
    assert n @ p2 <= d2.min() + tol


def _hull_cases(tm, d):
    """Captured driver inputs, and the same pairs re-posed at random: side 2
    is moved to overlap side 1 by a few mm along a random direction."""
    got = hull_inputs(tm, d)
    rng = np.random.default_rng(11)
    cases = []
    for name, (args, DX) in got.items():
        cases.append((name, args, DX))
        v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd = args
        u = torch.as_tensor(rng.standard_normal(c1.shape).astype(np.float32))
        u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
        shift = c1 + 0.03 * u - c2
        cases.append((name, (v1l, xm1, xp1, v2l, xm2, xp2 + shift, c1, c2 + shift, xd), DX))
    return cases


def _jax_hull(name, args, DX):
    import jax
    import jax.numpy as jnp
    from robogym_tpu.physics.collision import convex_kernel as j_ck

    dirs12 = jnp.asarray(j_ck._dirs12_np())
    ring = jnp.asarray(j_ck._ring_np())
    ref = j_ck._reference_hull_pair if name == "hull_pair" else j_ck._reference_hull_manifold

    def one(v1l, xm1, xp1, v2l, xm2, xp2, c1, c2, xd):
        v1 = j_ck._world_from_loc_xla(v1l, xm1, xp1)
        v2 = j_ck._world_from_loc_xla(v2l, xm2, xp2)
        return ref(v1, v2, c1, c2, xd, dirs12, ring, DX)

    return jax.jit(jax.vmap(one))(*[jnp.asarray(_np(a)) for a in args])


@pytest.mark.parametrize("name", ["hull_pair", "hull_manifold"])
def test_hull_plain_matches_jax(world, name):
    """D (hull_pair) and C (hull_manifold): <= 1e-5 where the chosen
    direction agrees; elsewhere the port's witness must be valid."""
    tm, d = world
    n_checked = n_tied = 0
    for case, args, DX in _hull_cases(tm, d):
        if case != name:
            continue
        plain = t_ck.hull_pair_plain if name == "hull_pair" else t_ck.hull_manifold_plain
        got = [_np(x) for x in plain(*args, DX)]
        want = [np.asarray(x) for x in _jax_hull(name, args, DX)]
        n_got, n_want = (got[2], want[2])
        same = np.abs(n_got - n_want).max(-1) <= 1e-6
        v1 = _np(t_ck.world_from_loc(*args[0:3]))
        v2 = _np(t_ck.world_from_loc(*args[3:6]))
        for idx in zip(*np.nonzero(same)):
            for g, w in zip(got, want):
                np.testing.assert_allclose(g[idx], w[idx], rtol=1e-5, atol=1e-5)
        for idx in zip(*np.nonzero(~same)):
            if name == "hull_pair":
                dist, pos, n, p2 = (g[idx] for g in got)
            else:
                # the witness pair is not an output of the manifold: check
                # the pair kernel's plain version at the same direction set
                dist, pos, n, p2 = (_np(x)[idx] for x in t_ck.hull_pair_plain(*args, DX))
            _assert_witnesses_valid(v1[idx], v2[idx], dist, n, 2.0 * pos - p2, p2)
        n_checked += same.size
        n_tied += int((~same).sum())
    assert n_checked > 0 and n_tied <= n_checked // 10, (n_tied, n_checked)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(world):
    """Each CUDA kernel against its plain version on the card, at B=4, as
    chip_smoke.py holds it. A <= 1e-5 rel on random SPD matrices (V=30) and
    on the matrices of one hand-world substep (V=24). B on the inputs of one
    locked-like substep (24 scalar rows) and one settle-world substep (no
    scalar row), F on one hand-world substep, B without the Euler update on
    one `forward()` of the locked-like world (`cg_readings`): after 1 and 2
    CG iterations, before float32 noise has grown, <= 1e-4 rel on every
    output; after all 15, each output's error against a float64 run of the
    plain version at most 2 times the float32 plain version's (the kernel
    sums in another order, and 15 unconverged iterations with a discrete
    line search carry that last-bit noise into the result). C and D <= 1e-5
    where the directions agree, with at most 1 in 10 pairs on a near-tie. E
    (`boxbox_readings`) on the inputs of one settle-world substep and the
    box cases of the plain version's test. The readings are printed
    (`-s`)."""
    import chip_smoke
    from robogym_torch import bridge

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    tm, d = world
    dev = "cuda"

    def on_card(tm, d):
        return bridge.model_to(tm, dev), bridge.data_from_numpy(bridge.data_to_numpy(d), dev)

    mc, dc = on_card(tm, d)
    ms, ds = on_card(*settle_state(B))
    mh, dh = on_card(*hand_state(B))
    for A in (torch.as_tensor(_spd(np.random.default_rng(0), 64, 30), device=dev),
              chip_smoke.capture_call(factor_kernel, "spd_inverse", lambda: t_step.step(mh, dh))[0]):
        assert _rel(_np(factor_kernel.spd_inverse(A)),
                    _np(factor_kernel.spd_inverse_plain(A))) <= 1e-5

    for name, hargs, DX in _hull_cases(tm, d):
        cargs = [a.to(dev) for a in hargs]
        kern = getattr(t_ck, name)
        plain = getattr(t_ck, name + "_plain")
        got = [_np(x) for x in kern(*cargs, DX)]
        want = [_np(x) for x in plain(*cargs, DX)]
        same = np.abs(got[2] - want[2]).max(-1) <= 1e-6
        assert (~same).sum() <= same.size // 10
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[same], w[same], rtol=1e-5, atol=1e-5)

    cases = [chip_smoke.capture_call(t_bb, "boxbox", lambda: t_step.fwd_position(ms, ds))]
    cases += [tuple(torch.as_tensor(a, device=dev) for a in c) for c in _box_cases().values()]
    for args in cases:
        got, want = t_bb.boxbox(*args), t_bb.boxbox_plain(*args)
        err, ties, total, failures = chip_smoke.boxbox_readings(args, got, want)
        print(f"boxbox: max abs err {err:.3g}, {ties} of {total} pairs on another axis")
        assert not failures, failures

    runs = {}
    for world_name, (m_, d_) in (("locked-like", (mc, dc)), ("settle", (ms, ds))):
        ci, its, nfacet = chip_smoke.capture_core(m_, d_)
        runs[f"cg_full on the {world_name} world"] = (
            "cg_full", lambda k, ci=ci, nfacet=nfacet: chip_smoke.cg_args(ci, k, nfacet), its)
    fa = chip_smoke.capture_call(cg_kernel, "cg", lambda: t_step.step(mh, dh))
    runs["cg"] = ("cg", lambda k: (*fa[:-1], k), fa[-1])
    kind_s, its_f, nfacet_f, *sargs = chip_smoke.capture_call(
        constraint_batched, "solve_core", lambda: t_step.forward(mc, dc))
    *head, Minv, qs, x0 = sargs
    ci_f = constraint_batched.row_inputs(kind_s, nfacet_f, *head)
    runs["cg_full_noeuler"] = (
        "cg_full_noeuler", lambda k: (ci_f["kind"], k, nfacet_f, ci_f["rows"], ci_f["maps"],
                                      ci_f["qM"], Minv, ci_f["qvel"], qs, x0), its_f)
    for label, (name, args_of, its) in runs.items():
        errs, early, noise, failures = chip_smoke.cg_readings(name, args_of, its)
        print(f"{label}: early {early}, after {its} {errs}, vs float64 {noise}")
        assert not failures, failures
    torch.cuda.synchronize()


def _rand_rot(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], axis=-2).astype(np.float32)


def _yaw(angles):
    c, s = np.cos(angles), np.sin(angles)
    z, o = np.zeros_like(c), np.ones_like(c)
    return np.stack([np.stack([c, -s, z], -1), np.stack([s, c, z], -1),
                     np.stack([z, z, o], -1)], -2).astype(np.float32)


def _box_cases():
    """Box-box inputs (xp1, xm1, s1, xp2, xm2, s2), each (B, K, ...):
    "random", touching and overlapping boxes at random poses (the cases of
    tests/test_boxbox_kernel.py); "stack", block-sized boxes resting on a
    table-sized one and on each other at random yaws, 0 to 1 mm deep, as on
    the settle world (the table's z axis ties with each block's); "tie",
    axis-aligned boxes overlapping by the same depth along x, y and z, an
    exact three-way tie of the SAT depth."""
    rng = np.random.default_rng(7)
    Bc, K = 4, 6
    xp1 = (rng.standard_normal((Bc, K, 3)) * 0.02).astype(np.float32)
    random = (xp1, _rand_rot(rng, Bc * K).reshape(Bc, K, 3, 3),
              (0.02 + rng.random((Bc, K, 3)) * 0.04).astype(np.float32),
              xp1 + (rng.standard_normal((Bc, K, 3)) * 0.04).astype(np.float32),
              _rand_rot(rng, Bc * K).reshape(Bc, K, 3, 3),
              (0.02 + rng.random((Bc, K, 3)) * 0.04).astype(np.float32))
    half, table = 0.0254, np.array([0.4, 0.4, 0.2], np.float32)
    below = np.zeros((Bc, K, 3), np.float32)
    xy = rng.uniform(-0.2, 0.2, (Bc, K, 2))
    depth = rng.uniform(0.0, 0.001, (Bc, K))
    on_table = np.concatenate([xy, (0.2 + half - depth)[..., None]], -1).astype(np.float32)
    below[:, 1::2] = on_table[:, 0::2]          # odd pairs: a block on a block
    xm_below = np.tile(np.eye(3, dtype=np.float32), (Bc, K, 1, 1))
    xm_below[:, 1::2] = _yaw(rng.uniform(-np.pi, np.pi, (Bc, K // 2)))
    s_below = np.tile(table, (Bc, K, 1))
    s_below[:, 1::2] = half
    above = on_table.copy()
    above[:, 1::2, 2] = below[:, 1::2, 2] + 2 * half - depth[:, 1::2]
    stack = (below, xm_below, s_below, above, _yaw(rng.uniform(-np.pi, np.pi, (Bc, K))),
             np.full((Bc, K, 3), half, np.float32))
    eye = np.tile(np.eye(3, dtype=np.float32), (Bc, K, 1, 1))
    s = np.full((Bc, K, 3), 0.05, np.float32)
    tie = (np.zeros((Bc, K, 3), np.float32), eye, s, np.full((Bc, K, 3), 0.099, np.float32),
           eye.copy(), s.copy())
    return {"random": random, "stack": stack, "tie": tie}


def _jax_boxbox_kernel(args):
    """The JAX package's box-box kernel in Pallas interpret mode."""
    import jax
    import jax.numpy as jnp
    from robogym_tpu.physics.collision import boxbox_kernel as j_bb

    with jax_boxbox_kernel():
        out = jax.jit(jax.vmap(j_bb.make_core()))(*[jnp.asarray(a) for a in args])
    return [np.asarray(x, np.float64) for x in out]


def _assert_same_manifold(got, want, atol=2e-5):
    """Equal sentinel masks; dist, pos and normal within atol on the
    candidates that are not sentinels."""
    gd, gp, gn = (np.asarray(x, np.float64) for x in got)
    wd, wp, wn = want
    valid = wd < 1e9
    np.testing.assert_array_equal(gd < 1e9, valid)
    np.testing.assert_allclose(gd[valid], wd[valid], rtol=0, atol=atol)
    np.testing.assert_allclose(gp[valid], wp[valid], rtol=0, atol=atol)
    np.testing.assert_allclose(gn[valid], wn[valid], rtol=0, atol=atol)


@pytest.mark.parametrize("case", ["random", "stack", "tie"])
def test_boxbox_plain_matches_jax_kernel(case):
    """E: `boxbox_plain` against the Pallas kernel it transcribes, 2e-5
    abs, on random poses, resting stacks and an exact tie (where both keep
    the first tied axis)."""
    args = _box_cases()[case]
    got = t_bb.boxbox_plain(*[torch.as_tensor(a) for a in args])
    _assert_same_manifold(got, _jax_boxbox_kernel(args))
    if case != "random":
        assert (np.asarray(got[0]) < 1e9).sum() >= 4 * args[0].shape[1], "too few contacts"


def test_boxbox_plain_matches_jax_primitive():
    """E away from ties: `boxbox_plain` against `primitives.box_box` on
    random poses, where no two SAT depths are within the primitive's 1e-7
    tie-break ramp of each other, 2e-5 abs."""
    import jax
    import jax.numpy as jnp
    from robogym_tpu.physics.collision import primitives as j_prim

    args = _box_cases()["random"]
    got = t_bb.boxbox_plain(*[torch.as_tensor(a) for a in args])
    want = jax.jit(jax.vmap(jax.vmap(j_prim.box_box)))(*[jnp.asarray(a) for a in args])
    _assert_same_manifold(got, [np.asarray(x, np.float64) for x in want])


@pytest.mark.parametrize("shape", [(4, 11, 5), (8, 24, 16)])
def test_cg_plain_matches_jax(shape):
    """F: `cg_plain` against the JAX package's scan solve
    (`_make_cg_core`) and its Pallas kernel in interpret mode
    (`solve_cg_batched`) on tests/test_cg_kernel.py's random problems, with
    that test's tolerances (float32 sums in other orders over 12
    iterations): x to 2e-3 rel + 5e-4 abs, f to 5e-3."""
    import jax
    import jax.numpy as jnp
    from robogym_tpu.physics import cg_kernel as j_ck
    from robogym_tpu.physics import constraint as j_con
    from test_cg_kernel import _random_problem

    J, aref, D, floss, M, Minv, qs, x0, kind = _random_problem(np.random.default_rng(0), *shape)
    iters = 12
    Deq, Done, Dfr = j_con.kind_masked_D(kind, jnp.asarray(D))
    jargs = (jnp.asarray(J), jnp.asarray(aref), Deq, Done, Dfr, jnp.asarray(floss),
             jnp.asarray(M), jnp.asarray(Minv), jnp.asarray(qs), jnp.asarray(x0))
    scan = jax.vmap(j_con._make_cg_core(iters))(*jargs)
    old = j_ck.INTERPRET
    j_ck.INTERPRET = True
    try:
        pallas = j_ck.solve_cg_batched(iters, *jargs)
    finally:
        j_ck.INTERPRET = old
    targs = [torch.as_tensor(np.array(a)) for a in jargs]
    x, f = cg_kernel.cg_plain(*targs, iters)
    for want in (scan, pallas):
        np.testing.assert_allclose(_np(x), np.asarray(want[0]), rtol=2e-3, atol=5e-4)
        np.testing.assert_allclose(_np(f), np.asarray(want[1]), rtol=5e-3, atol=5e-3)


def _solve_core_inputs(tm, d):
    """The no-Euler core's arguments as one `forward()` from state `d`
    passes them: (kind_s, iterations, nfacet, args)."""
    import chip_smoke

    kind_s, iterations, nfacet, *args = chip_smoke.capture_call(
        constraint_batched, "solve_core", lambda: t_step.forward(tm, d))
    return kind_s, iterations, nfacet, args


def test_solve_core_plain_matches_jax(world):
    """B without the Euler update: `solve_reference` against the JAX
    package's `_make_core(..., with_euler=False)` on the inputs of one
    `forward()` of the locked-like world, with the fused core's tolerances
    (qacc and efc_force 1e-4, qfrc 1e-2 relative)."""
    import jax
    import jax.numpy as jnp
    from robogym_tpu.physics import constraint_batched as j_cb

    tm, d = world
    kind_s, iterations, nfacet, args = _solve_core_inputs(tm, d)
    got = constraint_batched.solve_reference(kind_s, iterations, nfacet, *args)
    core = j_cb._make_core(kind_s.tobytes(), iterations, nfacet, False)
    jargs = [jnp.asarray(_np(a)) for a in args]
    in_axes = [None if a.ndim == 0 or k == 6 else 0 for k, a in enumerate(jargs)]
    want = jax.jit(jax.vmap(core, in_axes=in_axes))(*jargs)
    for (name, tol), g, w in zip(dict(qacc=1e-4, qfrc=1e-2, efc_force=1e-4).items(), got, want):
        assert _rel(_np(g), w) <= tol, (name, _rel(_np(g), w))
    assert (_np(got[2]) != 0).any(), "no constraint force: the state has no live rows"


def _wide_core_inputs(batch=4, V=40, n_s=8, S=80, nfacet=4, seed=5):
    """chip_smoke.py's seeded synthetic system for the fused core, wider
    than any world: by default V=40 dofs (two a lane in kernel B) and E =
    n_s + S*nfacet = 328 rows (past the 256 that kernel B keeps in
    registers). Returns (kind_s, iterations, nfacet, numpy args) in
    `fused_step_core`'s order."""
    import chip_smoke

    return chip_smoke.wide_core_inputs(batch, V, n_s, S, nfacet, seed)


def test_fused_core_plain_matches_jax_wide():
    """B at V=40 and E=328 (`_wide_core_inputs`): the plain core against
    the JAX package's reference, with the tolerances of
    test_fused_core_plain_matches_jax."""
    import jax
    import jax.numpy as jnp
    from robogym_tpu.physics import constraint_batched as j_cb

    kind_s, iterations, nfacet, args = _wide_core_inputs()
    got = constraint_batched.reference(kind_s, iterations, nfacet,
                                       *[torch.as_tensor(a) for a in args])
    core = j_cb._make_core(kind_s.tobytes(), iterations, nfacet, True, True)
    in_axes = [None if a.ndim == 0 or k == 6 else 0 for k, a in enumerate(args)]
    want = jax.jit(jax.vmap(core, in_axes=in_axes))(*[jnp.asarray(a) for a in args])
    tols = dict(qacc=1e-4, qfrc=1e-2, efc_force=1e-4, qvel_new=1e-4, qacc_smooth=1e-4)
    for (name, tol), g, w in zip(tols.items(), got, want):
        assert _rel(_np(g), w) <= tol, (name, _rel(_np(g), w))
    assert (_np(got[2]) != 0).sum() > 100, "too few live rows"


@pytest.mark.cuda
def test_cuda_cg_full_wide():
    """Kernel B with and without the Euler update at V=40 and E=328, two
    dofs a lane and rows past the register rows, against its plain version
    on the card, B=256 (`chip_smoke.cg_readings`: 1e-4 relative after 1 and
    2 iterations, after 15 at most 2 times the plain version's float32
    error against float64)."""
    import chip_smoke

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    kind_s, its, nfacet, args = _wide_core_inputs(batch=256)
    ci = constraint_batched.core_inputs(kind_s, nfacet,
                                        *[torch.as_tensor(a, device="cuda") for a in args])
    Minv = factor_kernel.spd_inverse_plain(ci["qM"])
    qs = torch.linalg.solve(ci["qM"], ci["qfrc_smooth"][..., None])[..., 0]
    runs = {"cg_full": lambda k: chip_smoke.cg_args(ci, k, nfacet),
            "cg_full_noeuler": lambda k: (ci["kind"], k, nfacet, ci["rows"], ci["maps"], ci["qM"],
                                          Minv, ci["qvel"], qs, ci["qacc_prev"])}
    for name, args_of in runs.items():
        errs, early, noise, failures = chip_smoke.cg_readings(name, args_of, its)
        print(f"{name} at V=40, E=328: early {early}, after {its} {errs}, vs float64 {noise}")
        assert not failures, failures


def test_fused_core_plain_matches_jax_without_scalar_rows():
    """B with n_s = 0: the fused core on the settle world (48 contacts, 4
    facets, no scalar row) against the JAX package's reference, with the
    tolerances of test_fused_core_plain_matches_jax."""
    import jax
    import jax.numpy as jnp
    from robogym_tpu.physics import constraint_batched as j_cb

    tm, d = settle_state(B)
    kind_s, iterations, nfacet, args = core_inputs(tm, d)
    assert len(kind_s) == 0 and args[0].shape[1] == 0
    got = constraint_batched.reference(kind_s, iterations, nfacet, *args)
    core = j_cb._make_core(kind_s.tobytes(), iterations, nfacet, True, True)
    jargs = [jnp.asarray(_np(a)) for a in args]
    in_axes = [None if a.ndim == 0 or k == 6 else 0 for k, a in enumerate(jargs)]
    want = jax.jit(jax.vmap(core, in_axes=in_axes))(*jargs)
    tols = dict(qacc=1e-4, qfrc=1e-2, efc_force=1e-4, qvel_new=1e-4, qacc_smooth=1e-4)
    for (name, tol), g, w in zip(tols.items(), got, want):
        assert _rel(_np(g), w) <= tol, (name, _rel(_np(g), w))
    assert (_np(got[2]) != 0).any(), "no contact force: the state has no live contact"


@pytest.mark.cuda
def test_cuda_locked_env_step_matches_plain_versions():
    """`LockedEnv.step` at B=64 on the card, from the env's reset state on
    the dactyl-shaped world (V=36: kernel A's two-rows-a-lane instance, B,
    C, D and E), through the kernels and through their plain versions
    (`chip_smoke.plain_versions`), with the same action and draws, each
    against the plain versions run in float64. Ten substeps carry the
    CG's float32 noise far into some envs (there the plain float32 step
    itself is rad/s off the float64 one; the test prints both errors), so, as
    `chip_smoke.cg_readings` holds a CG kernel: per group (the cube's
    position, qpos, qvel) the kernels' largest error against float64 is at
    most NOISE_RATIO times the plain versions' float32 error, or within the
    env-step envelope against the JAX package (2e-4 m, 1e-3, 5e-2). The
    tracker, done and the drop and success rewards equal the plain
    versions'; the launch counts are those of ten substeps."""
    import chip_smoke
    from _torch_common import CUBE_POS_TOL, QPOS_TOL, QVEL_TOL
    from robogym_torch import bridge, cuda
    from robogym_torch.envs import core
    from robogym_torch.envs.dactyl import locked

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    env = locked.make_env(device="cuda", seed=0)
    state, _ = env.reset(64)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    action = torch.rand((64, 20), generator=gen, device="cuda") * 2.0 - 1.0
    draws = env.draw_step(64)
    cuda.reset_launches()
    got = env.step(state, action, draws=draws)
    torch.cuda.synchronize()
    want_counts = {k: 10 * n for k, n in chip_smoke.PER_CALL["locked_env"].items()}
    assert {k: n for k, n in cuda.LAUNCHES.items() if n} == want_counts

    def f64(x):
        return x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x

    model32 = env.model
    with chip_smoke.plain_versions():
        want = env.step(state, action, draws=draws)
        env.model = bridge.model_to(model32, "cuda", torch.float64)
        try:
            ref = env.step(state.replace(physics=core.data_map(f64, state.physics),
                                         goal={k: f64(v) for k, v in state.goal.items()},
                                         prev_goal_distance={k: f64(v) for k, v in
                                                             state.prev_goal_distance.items()}),
                           f64(action), draws={k: f64(v) for k, v in draws.items()})
        finally:
            env.model = model32
    cube = torch.as_tensor(env.cube.cube_pos_qpos, device="cuda")
    for name, field, cols, tol in (("cube position", "qpos", cube, CUBE_POS_TOL),
                                   ("qpos", "qpos", slice(None), QPOS_TOL),
                                   ("qvel", "qvel", slice(None), QVEL_TOL)):
        r = getattr(ref[0].physics, field)[:, cols]
        e_k = float((getattr(got[0].physics, field)[:, cols].double() - r).abs().max())
        e_p = float((getattr(want[0].physics, field)[:, cols].double() - r).abs().max())
        print(f"locked env step, B=64, {name} vs float64: kernels {e_k:.3g}, plain {e_p:.3g}")
        assert e_k <= max(chip_smoke.NOISE_RATIO * e_p, tol), (name, e_k, e_p)
    for f in ("steps", "consecutive_successes", "successes_so_far", "goals_so_far"):
        assert torch.equal(getattr(got[0].tracker, f), getattr(want[0].tracker, f)), f
    assert torch.equal(got[3], want[3])
    assert torch.equal(got[2][:, 0], want[2][:, 0]) and torch.equal(got[2][:, 2], want[2][:, 2])
