"""Kernels A-D of the port: each plain version against the JAX package's
reference on seeded inputs at the locked-like world's shapes (B=4), and,
on a machine with an NVIDIA GPU, each CUDA kernel against its plain
version. These tests hold the math that the CUDA kernels reproduce.

JAX is imported inside the tests that compare with it: the card's machine
has none, and runs the `cuda` test with
`python -m pytest tests/test_torch_kernels.py --noconftest -m cuda`."""

import numpy as np
import pytest
import torch

from _torch_common import core_inputs, hull_inputs, locked_like_model, locked_like_state
from robogym_torch.physics import constraint_batched, factor_kernel
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
    """Each CUDA kernel against its plain version on the card, at the
    world's shapes: A <= 1e-5 rel. B (through the fused core, with A) as
    chip_smoke.py holds it: after 1 and 2 CG iterations, before float32
    noise has grown, <= 1e-4 rel on every output; after all 15, each
    output's error against a float64 run of the plain version at most 2
    times the float32 plain version's (the kernel sums in another order, and
    15 unconverged iterations with a discrete line search carry that
    last-bit noise into the result). C and D <= 1e-5 where the directions
    agree, with at most 1 in 10 pairs on a near-tie. The readings are
    printed (`-s`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    tm, d = world
    dev = "cuda"
    A = torch.as_tensor(_spd(np.random.default_rng(0), 64, 30), device=dev)
    assert _rel(_np(factor_kernel.spd_inverse(A)), _np(factor_kernel.spd_inverse_plain(A))) <= 1e-5

    kind_s, iterations, nfacet, args = core_inputs(tm, d)
    cargs = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    names = ("qacc", "efc_force", "qfrc", "qvel_new", "qacc_smooth")
    for its in (1, 2):
        got = constraint_batched.fused_step_core(kind_s, its, nfacet, *cargs)
        want = constraint_batched.reference(kind_s, its, nfacet, *cargs)
        errs = {n: _rel(_np(g), _np(w)) for n, g, w in zip(names, got, want)}
        print(f"cg_full after {its} iteration(s), rel err kernel vs plain: {errs}")
        assert max(errs.values()) <= 1e-4, errs
    got = constraint_batched.fused_step_core(kind_s, iterations, nfacet, *cargs)
    want = constraint_batched.reference(kind_s, iterations, nfacet, *cargs)
    exact = constraint_batched.reference(
        kind_s, iterations, nfacet, *[a.double() if isinstance(a, torch.Tensor) and
                                      a.is_floating_point() else a for a in cargs])
    for name, g, w, x in zip(names, got, want, exact):
        e_k, e_p = _rel(_np(g), _np(x)), _rel(_np(w), _np(x))
        print(f"cg_full {name}: kernel vs plain {_rel(_np(g), _np(w)):.3g}, "
              f"vs float64: kernel {e_k:.3g}, plain {e_p:.3g}")
        assert e_k <= 2 * e_p + 1e-6, (name, e_k, e_p)

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
    torch.cuda.synchronize()
