"""The tie-following reference of the CG kernels' check
(`chip_smoke.tie_reference`, `cg_readings`) and `cg_plain`'s forced
choices (`cg_kernel.Forced`), on the CPU.

`cg_plain` without `force` computes what it computed before forced
choices existed, bit for bit (its previous body is kept here); forced
picks replay a recorded trajectory; an engineered float32 tie of the line
search (a row that no search direction moves, whose penalty of 5e7 rounds
every cost to a multiple of 4) is excused with its witness; a departure
that no tie explains (the direction restarted in one env from iteration
5) is not. The systems are tests/test_cg_kernel.py's random problems; the
JAX package's scan solve holds the unforced plain version (2e-3 relative +
5e-4 absolute on x, 5e-3 on f, that test's tolerances). On the card
(marker `cuda`), kernels B and F on a seeded system pass the check, each
excused env with its witness."""

import numpy as np
import pytest
import torch

import chip_smoke
from robogym_torch.physics import cg_kernel
from robogym_torch.physics import constraint as cl
from robogym_torch.physics.smooth import mv

ITS = 15


def _problem(seed=0, B=4, E=11, V=5, constant_row=None):
    """`cg_plain`'s arguments (torch) for a random problem; with
    `constant_row` one more equality row whose J is 0 and whose jar is
    `constant_row`."""
    from test_cg_kernel import _random_problem

    J, aref, D, floss, M, Minv, qs, x0, kind = _random_problem(np.random.default_rng(seed),
                                                               B, E, V)
    if constant_row is not None:
        J = np.concatenate([J, np.zeros((B, 1, V), np.float32)], 1)
        aref = np.concatenate([aref, np.full((B, 1), -constant_row, np.float32)], 1)
        D = np.concatenate([D, np.ones((B, 1), np.float32)], 1)
        floss = np.concatenate([floss, np.zeros((B, 1), np.float32)], 1)
        kind = np.concatenate([kind, [cl.EQ]]).astype(np.int32)
    t = [torch.as_tensor(np.ascontiguousarray(a)) for a in (J, aref, D, floss, M, Minv, qs, x0)]
    J, aref, D, floss, M, Minv, qs, x0 = t
    Deq, Done, Dfr = cl.kind_masked_D(kind, D)
    return (J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0), kind


def _cg_plain_before(J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, iterations):
    """`cg_plain` as it was before `force` (its body, the trace left out)."""

    def force(jar):
        neg = (jar < 0).to(jar.dtype)
        return Deq * jar + Done * jar * neg + torch.minimum(torch.maximum(Dfr * jar, -floss), floss)

    def penalty_cost(jar):
        neg = (jar < 0).to(jar.dtype)
        c_quad = 0.5 * (Deq + Done * neg) * jar * jar
        inside = (torch.abs(Dfr * jar) < floss).to(jar.dtype)
        quad_f = 0.5 * Dfr * jar * jar
        lin_f = floss * torch.abs(jar) - 0.5 * floss * floss / torch.clamp(Dfr, min=1e-12)
        c_fric = inside * quad_f + (1.0 - inside) * lin_f
        return torch.sum(c_quad + c_fric, dim=-1)

    def grad(x, jar):
        return mv(M, x - qs) + mv(J.transpose(-1, -2), force(jar))

    def dot(a, b):
        return torch.sum(a * b, dim=-1)

    x = x0
    jar = mv(J, x0) - aref
    g = grad(x0, jar)
    Mg = mv(Minv, g)
    p = -Mg
    for _ in range(iterations):
        Jp = mv(J, p)
        dx0 = x - qs
        Mp = mv(M, p)
        c1 = dot(dx0, Mp)
        c2 = dot(p, Mp)
        f0 = force(jar)
        neg = (jar < 0).to(x.dtype)
        inside = (torch.abs(Dfr * jar) < floss).to(x.dtype)
        deff = Deq + Done * neg + Dfr * inside
        phi_p = c1 + dot(f0, Jp)
        phi_pp = torch.clamp(c2 + dot(deff * Jp, Jp), min=1e-12)
        a1 = torch.clamp(-phi_p / phi_pp, 0.0, 2.0)
        pen0 = penalty_cost(jar)
        best_cost = torch.zeros_like(c1)
        best_a = torch.zeros_like(c1)
        for s in cl.LS_SCALES:
            a = a1 * s
            dcost = a * c1 + 0.5 * a * a * c2 + penalty_cost(jar + a[:, None] * Jp) - pen0
            take = dcost < best_cost
            best_cost = torch.where(take, dcost, best_cost)
            best_a = torch.where(take, a, best_a)
        x = x + best_a[:, None] * p
        jar = jar + best_a[:, None] * Jp
        g_new = grad(x, jar)
        Mg_new = mv(Minv, g_new)
        num = dot(g_new, Mg_new - Mg)
        den = torch.clamp(dot(g, Mg), min=1e-12)
        beta = torch.clamp(num / den, min=0.0)
        p = -Mg_new + beta[:, None] * p
        g, Mg = g_new, Mg_new
    return x, -force(jar)


def _traced(solve):
    """A stand-in kernel F from a solve with `cg_plain`'s arguments: with
    `trace` it also returns the solve's states as the kernel's trace gives
    them (`cg_kernel.split_trace`'s fields), for the one-step check."""

    def kernel(*a, trace=False):
        if not trace:
            return solve(*a)
        states = []
        x, f = solve(*a, states=states)
        return x, f, cg_kernel.stack_states(states)

    return kernel


def _restarted(env, start):
    """A stand-in kernel F: `cg_plain`'s solve with the search direction of
    env `env` restarted (beta = 0) from iteration `start` on, as
    tools/cg_fault_check.py's `late_restart_few_envs` plants it."""

    def kernel(J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, iterations, **kw):
        clamp = torch.clamp
        it = [0]

        def counted(t, *a, **kw):
            out = clamp(t, *a, **kw)
            if kw.get("min") == 0.0 and not a and t.dim() == 1 and t.shape[0] == J.shape[0]:
                # beta of iteration it[0] (the only 1-d clamp at min 0 after a1's)
                it[0] += 1
                if it[0] > start:
                    out = out.clone()
                    out[env] = 0.0
            return out

        torch.clamp = counted
        try:
            return cg_kernel.cg_plain(J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, iterations,
                                      **kw)
        finally:
            torch.clamp = clamp

    return _traced(kernel)


@pytest.fixture
def no_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.mark.parametrize("seed,shape", [(0, (4, 11, 5)), (1, (8, 24, 16)), (2, (6, 40, 12))])
def test_unforced_cg_plain_is_unchanged(seed, shape):
    """Without `force`, with all choices left free, and with a trace,
    `cg_plain` returns its previous body's outputs bit for bit; and it
    agrees with the JAX package's scan solve."""
    import jax
    import jax.numpy as jnp
    from robogym_tpu.physics import constraint as j_con

    args, kind = _problem(seed, *shape)
    want = _cg_plain_before(*args, ITS)
    free = cg_kernel.Forced.free(shape[0], ITS, shape[1], "cpu")
    for got in (cg_kernel.cg_plain(*args, ITS), cg_kernel.cg_plain(*args, ITS, force=free),
                cg_kernel.cg_plain(*args, ITS, trace=[])):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    jx = jax.vmap(j_con._make_cg_core(ITS))(*[jnp.asarray(a.numpy()) for a in args])
    np.testing.assert_allclose(want[0].numpy(), np.asarray(jx[0]), rtol=2e-3, atol=5e-4)
    np.testing.assert_allclose(want[1].numpy(), np.asarray(jx[1]), rtol=5e-3, atol=5e-3)


def test_forced_picks_replay_a_recorded_trajectory():
    """The picks of a run with arbitrary forced choices, recorded by its
    trace, replayed as forced picks give that run bit for bit; the trace
    records the forced picks where they are forced, and an unforced run's
    own picks replayed give the unforced run."""
    args, _ = _problem(3, 8, 24, 16)
    B = 8
    trace = []
    free = cg_kernel.cg_plain(*args, ITS, trace=trace)
    picks = torch.stack([t["pick"] for t in trace], 1)
    replay = cg_kernel.Forced.free(B, ITS, 24, "cpu")
    replay.pick = picks.clone()
    assert all(torch.equal(g, w) for g, w in zip(cg_kernel.cg_plain(*args, ITS, force=replay),
                                                 free))
    rng = np.random.default_rng(5)
    arbitrary = cg_kernel.Forced.free(B, ITS, 24, "cpu")
    arbitrary.pick = torch.as_tensor(np.where(rng.random((B, ITS)) < 0.3,
                                              rng.integers(0, 5, (B, ITS)), -1))
    trace2 = []
    forced = cg_kernel.cg_plain(*args, ITS, trace=trace2, force=arbitrary)
    recorded = torch.stack([t["pick"] for t in trace2], 1)
    set_ = arbitrary.pick >= 0
    assert torch.equal(recorded[set_], arbitrary.pick[set_])
    steps = torch.stack([t["step"] for t in trace2], 1)
    cand = torch.cat([torch.stack([t["a"] for t in trace2], 1),
                      torch.zeros(B, ITS, 1)], -1)
    assert torch.equal(steps, cand.gather(-1, recorded[..., None])[..., 0])
    again = cg_kernel.Forced.free(B, ITS, 24, "cpu")
    again.pick = recorded
    assert all(torch.equal(g, w) for g, w in zip(cg_kernel.cg_plain(*args, ITS, force=again),
                                                 forced))
    assert not torch.equal(forced[0], free[0])


def test_engineered_tie_is_excused_with_its_witness(no_sync):
    """A stand-in kernel F that takes another line-search candidate than
    the plain version at iteration 3 of env 2, where a row that J leaves
    at jar = 1e4 (penalty 5e7) puts every cost within float32's rounding of
    the others: the check forces that choice, names the witness (the two
    costs, their difference within the bound), and passes."""
    args, _ = _problem(4, 4, 11, 5, constant_row=1e4)
    trace = []
    cg_kernel.cg_plain(*args, ITS, trace=trace)
    t = trace[2]
    ref = int(t["pick"][2])
    a = torch.cat([t["a"][2], torch.zeros(1)])
    alt = next(j for j in range(5) if j != ref and abs(float(a[j] - a[ref])) > 1e-3 * float(a.abs().max()))
    planted = cg_kernel.Forced.free(4, ITS, 12, "cpu")
    planted.pick[2, 2] = alt

    kernel = _traced(lambda *a, **kw: cg_kernel.cg_plain(*a, force=planted, **kw))

    report = {}
    with chip_smoke.patched([((cg_kernel, "cg"), kernel)]):
        errs, early, noise, failures = chip_smoke.cg_readings("cg", lambda k: (*args, k), ITS,
                                                              report)
    assert not failures, failures
    assert [(env, it) for env, it, _ in report["excused"]] == [(2, 3)]
    w = report["excused"][0][2]
    assert w["kind"] == "pick" and w["diff"] <= w["bound"]
    assert w["picks"][0] == ref
    got = kernel(*args, ITS)
    want = cg_kernel.cg_plain(*args, ITS, force=report["force"])
    assert all(torch.equal(g, x) for g, x in zip(got, want))
    assert "iteration 3" in chip_smoke.witness_text(*report["excused"][0])


@pytest.mark.parametrize("planted", [((1, 3), (3, 3), (6, 9)), ((0, 2), (0, 7), (5, 12))])
def test_engineered_ties_in_several_envs_are_excused_together(no_sync, monkeypatch, planted):
    """Ties planted in several envs and iterations of the constant-row
    system (B=8; two in one env in the second case), their candidates
    tried in chunks of 3: each planted env is excused, every other env
    follows the plain version, and the forced reference reproduces the
    stand-in kernel bit for bit."""
    monkeypatch.setattr(chip_smoke, "CANDIDATE_CHUNK", 3)
    args, _ = _problem(6, 8, 11, 5, constant_row=1e4)
    planted_force = cg_kernel.Forced.free(8, ITS, 12, "cpu")
    for env, it in planted:
        trace = []
        cg_kernel.cg_plain(*args, ITS, trace=trace, force=planted_force)
        t = trace[it - 1]
        a = torch.cat([t["a"][env], torch.zeros(1)])
        ref = int(t["pick"][env])
        planted_force.pick[env, it - 1] = next(
            j for j in range(5) if abs(float(a[j] - a[ref])) > 1e-3 * float(a.abs().max()))

    kernel = _traced(lambda *a, **kw: cg_kernel.cg_plain(*a, force=planted_force, **kw))

    report = {}
    with chip_smoke.patched([((cg_kernel, "cg"), kernel)]):
        _, _, _, failures = chip_smoke.cg_readings("cg", lambda k: (*args, k), ITS, report)
    assert not failures, failures
    assert {env for env, _, _ in report["excused"]} == {env for env, _ in planted}
    assert report["drifting"] == []
    got = kernel(*args, ITS)
    want = cg_kernel.cg_plain(*args, ITS, force=report["force"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_departure_without_a_tie_is_not_excused(no_sync):
    """A stand-in kernel F whose env 1 restarts its search direction from
    iteration 5 (no float32 tie there): env 1 is not excused (it leaves
    the forced plain version with no tie, after the early iterations, and
    the noise check holds it); the other envs neither leave nor are
    excused. The same restart from iteration 2 fails the check by naming
    env 1 (it leaves within the early iterations)."""
    args, _ = _problem(1, 8, 24, 16)
    kernel = _restarted(1, 5)
    assert not torch.equal(kernel(*args, ITS)[0], cg_kernel.cg_plain(*args, ITS)[0])
    assert torch.equal(kernel(*args, 5)[0], cg_kernel.cg_plain(*args, 5)[0])
    report = {}
    with chip_smoke.patched([((cg_kernel, "cg"), kernel)]):
        _, _, _, failures = chip_smoke.cg_readings("cg", lambda k: (*args, k), ITS, report)
    assert [env for env, _, _ in report["drifting"]] == [1]
    assert report["excused"] == []
    assert not any(f.startswith("env ") for f in failures)
    report = {}
    with chip_smoke.patched([((cg_kernel, "cg"), _restarted(1, 0))]):
        _, _, _, failures = chip_smoke.cg_readings("cg", lambda k: (*args, k), ITS, report)
    assert failures and failures[0].startswith("env 1 after 2 iteration(s): leaves with no tie")
    assert not any(f.startswith(f"env {e} ") for f in failures for e in (0, 2, 3, 4, 5, 6, 7))


def test_fused_check_passes_the_plain_version(no_sync):
    """The check on kernel B's arguments (`cg_full`, the captured locked-
    like substep at B=4) with the plain version in the kernel's place: no
    env leaves, none is excused, and the forced reference is the plain
    version itself."""
    from _torch_common import locked_like_model, locked_like_state

    tm = locked_like_model()
    d = locked_like_state(tm, 4, seed=0)
    ci, its, nfacet = chip_smoke.capture_core(tm, d)
    report = {}
    errs, early, noise, failures = chip_smoke.cg_readings(
        "cg_full", lambda k: chip_smoke.cg_args(ci, k, nfacet), its, report)
    assert not failures and report["excused"] == []
    assert all(e == 0.0 for e in errs.values())
    assert bool((report["force"].pick == -1).all())


@pytest.mark.cuda
def test_cuda_tie_check_holds_kernels_b_and_f():
    """Kernel B (`cg_full`) and kernel F (`cg`) on `chip_smoke.wide_core_inputs`
    at V=40, E=328, B=256 on the card: the check passes, and every excused
    env's witness lies within its bound."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from robogym_torch.physics import constraint_batched
    from robogym_torch.physics import factor_kernel

    kind_s, its, nfacet, args = chip_smoke.wide_core_inputs(256, V=40, S=80)
    ci = constraint_batched.core_inputs(kind_s, nfacet,
                                        *[torch.as_tensor(a, device="cuda") for a in args])
    Minv = factor_kernel.spd_inverse_plain(ci["qM"])
    qs = torch.linalg.solve(ci["qM"], ci["qfrc_smooth"][..., None])[..., 0].contiguous()
    ins = (*cg_kernel.solve_inputs(ci["kind"], nfacet, ci["rows"], ci["maps"], ci["qvel"]),
           ci["qM"], Minv, qs, ci["qacc_prev"])
    for name, args_of in (("cg_full", lambda k: chip_smoke.cg_args(ci, k, nfacet)),
                          ("cg", lambda k: (*ins, k))):
        report = {}
        errs, early, noise, failures = chip_smoke.cg_readings(name, args_of, its, report)
        print(f"{name}: excused {[chip_smoke.witness_text(*w) for w in report['excused']]}; "
              f"early {early}; after {its} {errs}; vs float64 {noise}")
        assert not failures, failures
        for _, _, w in report["excused"]:
            assert (w["diff"] <= w["bound"]) if w["kind"] == "pick" else \
                (abs(w["jar"]) <= w["bound"] or w["kind"] == "inside")
