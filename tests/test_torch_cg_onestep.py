"""The one-step check of the CG kernels (`chip_smoke.one_step_readings`):
each CG iteration held from the kernel's own traced state, on the CPU.

`cg_plain(start=)` without a start computes what it computed before, bit
for bit (the body kept in tests/test_torch_cg_ties.py); k iterations and
then one more from the state after k equal k + 1 iterations bit for bit,
for `cg_plain` and through the fused plain version (`cg_full_plain`). The
check passes the plain version in the kernel's place; it fails a stand-in
kernel F whose beta is zeroed in a few envs at iteration 10, one whose
line search takes a step outside the tie bound, and one whose trace lacks
its last slot. The systems are tests/test_cg_kernel.py's random problems
and the captured locked-like substep at B=4.

Kernels B and F's CUDA sources run on the CPU (tests/host_cuda, as
test_torch_cg_host.py and test_torch_cg_full_host.py run them, at B=2):
with the trace their outputs equal those without it bit for bit, the
one-step check passes them, and it fails the sources with two of
tools/cg_fault_check.py's faults planted in a copy (`late_restart_few_envs`
on beta, `trace_skips_last_iteration` on the missing trace). On the card
(marker `cuda`), kernels B and F with their trace give outputs equal to
those without it, and the one-step check passes them."""

import os
import re
import shutil
import subprocess

import pytest
import torch

import chip_smoke
from robogym_torch.physics import cg_kernel
from test_torch_cg_ties import _cg_plain_before, _problem, _traced

ITS = 15
HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "robogym_torch", "csrc")


@pytest.fixture
def no_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


@pytest.mark.parametrize("seed,shape", [(0, (4, 11, 5)), (1, (8, 24, 16)), (2, (6, 40, 12))])
def test_start_is_bit_for_bit(seed, shape):
    """Without `start` the solve is its previous body's; from the state
    after k iterations (`states`), one more iteration gives the state and
    the outputs of k + 1 iterations bit for bit, for every k."""
    args, _ = _problem(seed, *shape)
    want = _cg_plain_before(*args, ITS)
    states = []
    got = cg_kernel.cg_plain(*args, ITS, states=states)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert len(states) == ITS + 1
    for k in range(ITS):
        start = {f: states[k][f] for f in cg_kernel.STATE_FIELDS}
        step = []
        out = cg_kernel.cg_plain(*args, 1, start=start, states=step)
        for f in states[k + 1]:
            assert torch.equal(step[1][f], states[k + 1][f]), (k, f)
        assert all(torch.equal(o, w) for o, w in zip(out, _cg_plain_before(*args, k + 1)))


def test_start_through_the_fused_plain_version():
    """The fused plain version (`cg_full_plain`) on the captured locked-
    like substep: its solve's state after k iterations, with qacc_smooth,
    run one more iteration, gives the outputs of k + 1 iterations bit for
    bit; the wrapper's CPU trace is that solve's states."""
    import functools

    from _torch_common import locked_like_model, locked_like_state

    tm = locked_like_model()
    ci, its, nfacet = chip_smoke.capture_core(tm, locked_like_state(tm, 4, seed=0))
    *outs, tr = cg_kernel.cg_full(*chip_smoke.cg_args(ci, its, nfacet), trace=True)
    assert all(torch.equal(o, w) for o, w in zip(outs, cg_kernel.cg_full_plain(
        *chip_smoke.cg_args(ci, its, nfacet))))
    for k in (0, 4, its - 1):
        start = {f: tr[f][:, k] for f in cg_kernel.STATE_FIELDS}
        start["qs"] = outs[4]
        got = cg_kernel.cg_full_plain(*chip_smoke.cg_args(ci, 1, nfacet),
                                      solve=functools.partial(cg_kernel.cg_plain, start=start))
        want = cg_kernel.cg_full_plain(*chip_smoke.cg_args(ci, k + 1, nfacet))
        assert all(torch.equal(g, w) for g, w in zip(got, want)), k


def test_check_passes_the_plain_version(no_sync):
    """The plain versions of F (a random problem) and of B (`cg_full`, the
    captured locked-like substep) in the kernels' place: the one-step
    check passes with no error, no env excused, and the output stage
    equal."""
    from _torch_common import locked_like_model, locked_like_state

    args, _ = _problem(1, 8, 24, 16)
    tm = locked_like_model()
    ci, its, nfacet = chip_smoke.capture_core(tm, locked_like_state(tm, 4, seed=0))
    for name, args_of, n in (("cg", lambda k: (*args, k), ITS),
                             ("cg_full", lambda k: chip_smoke.cg_args(ci, k, nfacet), its)):
        r = chip_smoke.one_step_readings(name, args_of, n)
        assert r["failures"] == [] and r["excused"] == []
        assert all(w == 0.0 for w, _ in r["worst"].values()), r["worst"]
        assert all(e == 0.0 for e in r["outputs"].values())
        report = {}
        assert chip_smoke.cg_readings(name, args_of, n, report)[3] == []
        assert report["one_step"]["failures"] == []


def _beta_zeroed(envs, iteration):
    """A stand-in kernel F: `cg_plain` with beta set to 0 in `envs` at
    `iteration` (1-based) only."""
    clamp = torch.clamp

    def solve(*a, **kw):
        it = [0]
        B = a[0].shape[0]

        def counted(t, *ca, **ckw):
            out = clamp(t, *ca, **ckw)
            if ckw.get("min") == 0.0 and not ca and t.dim() == 1 and t.shape[0] == B:
                it[0] += 1   # beta of iteration it[0], the only such clamp
                if it[0] == iteration:
                    out = out.clone()
                    out[envs] = 0.0
            return out

        torch.clamp = counted
        try:
            return cg_kernel.cg_plain(*a, **kw)
        finally:
            torch.clamp = clamp

    return _traced(solve)


def test_check_fails_beta_zeroed_at_iteration_10(no_sync):
    """beta zeroed in envs 3 and 7 at iteration 10 (where the plain
    version's is 0.12 and 0.79): the check fails on beta after iteration
    10, naming those envs, and on nothing before."""
    args, _ = _problem(1, 8, 24, 16)
    plain = _traced(cg_kernel.cg_plain)(*args, ITS, trace=True)[2]
    assert bool((plain["beta"][[3, 7], 10] > 0.1).all())
    kernel = _beta_zeroed([3, 7], 10)
    tr = kernel(*args, ITS, trace=True)[2]
    assert bool((tr["beta"][[3, 7], 10] == 0).all())
    with chip_smoke.patched([((cg_kernel, "cg"), kernel)]):
        r = chip_smoke.one_step_readings("cg", lambda k: (*args, k), ITS)
    beta = [f for f in r["failures"] if f.startswith("one-step beta")]
    assert beta and beta[0].startswith("one-step beta after iteration 10: envs [3, 7]"), r
    assert not any("iteration 9" in f or "iteration 8" in f for f in r["failures"])


def test_check_fails_a_pick_outside_the_bound(no_sync):
    """A stand-in kernel F whose line search takes another candidate than
    the plain version's at iteration 6 of env 3, where the costs lie far
    apart: the check names that env and step, and excuses nothing."""
    args, _ = _problem(1, 8, 24, 16)
    trace = []
    cg_kernel.cg_plain(*args, ITS, trace=trace)
    t = trace[5]
    ref = int(t["pick"][3])
    cost = torch.cat([t["dcost"][3], torch.zeros(1)])
    bnd = torch.cat([chip_smoke.tie_bound(t["mag"][3]), torch.zeros(1)])
    alt = next(j for j in range(5)
               if j != ref and float((cost[j] - cost[ref]).abs()) > 100 * float(bnd[j] + bnd[ref]))
    planted = cg_kernel.Forced.free(8, ITS, 24, "cpu")
    planted.pick[3, 5] = alt
    kernel = _traced(lambda *a, **kw: cg_kernel.cg_plain(*a, force=planted, **kw))
    with chip_smoke.patched([((cg_kernel, "cg"), kernel)]):
        r = chip_smoke.one_step_readings("cg", lambda k: (*args, k), ITS)
    assert r["excused"] == []
    assert any(f.startswith(f"one-step pick at iteration 6: env 3 picks {alt}")
               for f in r["failures"]), r["failures"]


def test_check_refuses_a_missing_trace(no_sync):
    """A stand-in kernel F whose trace lacks its last slot (NaN, as the
    kernels' trace buffer starts): the check fails on the missing trace."""
    args, _ = _problem(1, 8, 24, 16)
    traced = _traced(cg_kernel.cg_plain)

    def kernel(*a, trace=False):
        out = traced(*a, trace=trace)
        if trace:
            out[2]["x"] = out[2]["x"].clone()
            out[2]["x"][:, -1] = float("nan")
        return out

    with chip_smoke.patched([((cg_kernel, "cg"), kernel)]):
        r = chip_smoke.one_step_readings("cg", lambda k: (*args, k), ITS)
    assert r["failures"] == [f"one-step: the trace is missing or malformed at slots [{ITS}] of "
                             f"{ITS + 1}"]


def _host_runner(out, csrc, kernel):
    """Kernel `kernel` ("cg" or "cg_full") of the sources in `csrc` built
    for the host into `out`, as the host tests build it: (runner, dir)."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to run the CUDA source on the host")
    with open(os.path.join(csrc, kernel + ".cu")) as f:
        src = re.sub(r"<<<[^>]*>>>", "", f.read()).replace("  extern __shared__ float sm[];\n", "")
    (out / f"{kernel}_host.cpp").write_text(src)
    exe = out / f"run_{kernel}"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off",
                    "-Wno-unknown-pragmas", f"-I{out}", f"-I{os.path.join(HERE, 'host_cuda')}",
                    f"-I{csrc}", "-o", str(exe),
                    os.path.join(HERE, "host_cuda", f"run_{kernel}.cpp")],
                   check=True, capture_output=True, text=True)
    return str(exe), out


def _planted(tmp, fault):
    """A copy of the sources with tools/cg_fault_check.py's `fault`."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "cg_fault_check", os.path.join(os.path.dirname(HERE), "tools", "cg_fault_check.py"))
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    path, old, new, _ = fc.FAULTS[fault]
    dst = tmp / ("csrc_" + fault)
    shutil.copytree(CSRC, dst)
    text = (dst / path).read_text()
    assert text.count(old) == 1
    (dst / path).write_text(text.replace(old, new))
    return str(dst)


def _host_f(runner, route):
    """A stand-in for `cg_kernel.cg`: kernel F's source on the host."""
    import test_torch_cg_host as h

    def kernel(*a, trace=False):
        return h._run(runner, a, route, trace)

    return kernel


def _host_b(runner):
    """A stand-in for `cg_kernel.cg_full`: kernel B's source on the host."""
    import test_torch_cg_full_host as h

    def kernel(*a, trace=False):
        return h._run(runner, a, True, trace)

    return kernel


@pytest.fixture(scope="module")
def host_f(tmp_path_factory):
    return _host_runner(tmp_path_factory.mktemp("host_f"), CSRC, "cg")


def test_host_kernels_trace_and_pass_the_check(no_sync, host_f, tmp_path):
    """Kernel F (J in shared and in device memory, the hand world's
    substep) and kernel B (the locked-like substep) on the host: the
    outputs with the trace equal those without it bit for bit, the trace's
    last slot holds the returned x, and the one-step check passes."""
    import test_torch_cg_full_host as bh
    import test_torch_cg_host as fh
    from _torch_common import hand_state
    from robogym_torch.physics import step as t_step

    tm, d = hand_state(2)
    fa = chip_smoke.capture_call(cg_kernel, "cg", lambda: t_step.step(tm, d))
    ci, its, nfacet = bh._case("locked_like")
    cases = [("cg", _host_f(host_f, route), lambda k: (*fa[:-1], k), fa[-1])
             for route in (fh.SHARED, fh.DEVICE)]
    cases.append(("cg_full", _host_b(_host_runner(tmp_path, CSRC, "cg_full")),
                  lambda k: chip_smoke.cg_args(ci, k, nfacet), its))
    for name, kernel, args_of, n in cases:
        off = kernel(*args_of(n))
        *on, tr = kernel(*args_of(n), trace=True)
        assert all(torch.equal(a, b) for a, b in zip(off, on)), name
        assert torch.equal(tr["x"][:, -1], off[0])
        with chip_smoke.patched([((cg_kernel, name), kernel)]):
            r = chip_smoke.one_step_readings(name, args_of, n)
        assert r["failures"] == [], (name, r["failures"])
        assert all(w <= 1.0 for w, _ in r["worst"].values()), r["worst"]


@pytest.mark.parametrize("fault,want", [
    ("late_restart_few_envs", "one-step beta after iteration 6: envs [0]"),
    ("trace_skips_last_iteration", "one-step: the trace is missing or malformed at slots [15]")])
def test_host_kernel_with_a_planted_fault_fails(no_sync, tmp_path, fault, want):
    """Kernel F's source with a fault of tools/cg_fault_check.py planted,
    on the host (J in device memory, the wide system's first two envs,
    where env 0 restarts its direction from iteration 6): the one-step
    check names the fault's field and step."""
    import test_torch_cg_host as fh

    runner = _host_runner(tmp_path, _planted(tmp_path, fault), "cg")
    args = fh._wide_args()
    with chip_smoke.patched([((cg_kernel, "cg"), _host_f(runner, fh.DEVICE))]):
        r = chip_smoke.one_step_readings("cg", lambda k: (*args[:-1], k), args[-1])
    assert any(f.startswith(want) for f in r["failures"]), r["failures"]


@pytest.mark.cuda
def test_cuda_trace_leaves_the_outputs_as_they_are():
    """Kernels B (`cg_full`, `cg_full_noeuler`) and F (`cg`) on
    `chip_smoke.wide_core_inputs` at V=40, E=328, B=256 on the card: the
    outputs with the trace are `torch.equal` to those without it, the
    trace is whole, and its last slot holds the returned x."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    from robogym_torch.physics import constraint_batched, factor_kernel

    kind_s, its, nfacet, args = chip_smoke.wide_core_inputs(256, V=40, S=80)
    ci = constraint_batched.core_inputs(kind_s, nfacet,
                                        *[torch.as_tensor(a, device="cuda") for a in args])
    Minv = factor_kernel.spd_inverse_plain(ci["qM"])
    qs = torch.linalg.solve(ci["qM"], ci["qfrc_smooth"][..., None])[..., 0].contiguous()
    ins = (*cg_kernel.solve_inputs(ci["kind"], nfacet, ci["rows"], ci["maps"], ci["qvel"]),
           ci["qM"], Minv, qs, ci["qacc_prev"], its)
    noeuler = (ci["kind"], its, nfacet, ci["rows"], ci["maps"], ci["qM"], Minv, ci["qvel"], qs,
               ci["qacc_prev"])
    for fn, a in ((cg_kernel.cg_full, chip_smoke.cg_args(ci, its, nfacet)),
                  (cg_kernel.cg_full_noeuler, noeuler), (cg_kernel.cg, ins)):
        off = fn(*a)
        *on, tr = fn(*a, trace=True)
        assert all(torch.equal(x, y) for x, y in zip(off, on)), fn.__name__
        assert all(bool(torch.isfinite(v).all()) for v in tr.values()), fn.__name__
        assert torch.equal(tr["x"][:, -1], off[0])
        picks = tr["pick"][:, 1:]
        assert bool(((picks >= 0) & (picks <= 4)).all()) and bool((tr["pick"][:, 0] == -1).all())
        r = chip_smoke.one_step_readings(fn.__name__, lambda k: (*a[:-1], k) if fn is cg_kernel.cg
                                         else (a[0], k, *a[2:]), its)
        print(fn.__name__, r["worst"], len(r["excused"]), r["outputs"])
        assert r["failures"] == [], r["failures"]
