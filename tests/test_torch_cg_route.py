"""The route of oversized constraint systems stays honest on the CPU: the
CG wrappers take their plain versions on CPU tensors, and threading the
solve through `cg_full_noeuler_plain(..., solve=...)` leaves the plain
versions' results bit for bit as they were (the solve spelled out as it
was before the route existed), on the inputs of one locked-like and one
goal-settle substep (B=4)."""

import pytest
import torch

from _torch_common import core_inputs, locked_like_model, locked_like_state, settle_state
from robogym_torch.physics import cg_kernel, constraint, constraint_batched, factor_kernel
from robogym_torch.physics.smooth import mv

import chip_smoke

B = 4


@pytest.fixture(scope="module", params=["locked_like", "settle"])
def case(request):
    """(core_inputs dict, iterations, nfacet) of one substep."""
    if request.param == "locked_like":
        tm = locked_like_model()
        kind_s, its, nfacet, args = core_inputs(tm, locked_like_state(tm, B, seed=0))
    else:
        kind_s, its, nfacet, args = core_inputs(*settle_state(B))
    return constraint_batched.core_inputs(kind_s, nfacet, *args), its, nfacet


def _noeuler_args(ci, its, nfacet):
    Minv = factor_kernel.spd_inverse_plain(ci["qM"])
    qs = mv(Minv, ci["qfrc_smooth"])
    return (ci["kind"], its, nfacet, ci["rows"], ci["maps"], ci["qM"], Minv, ci["qvel"], qs,
            ci["qacc_prev"])


def _noeuler_as_before(kind, iterations, nfacet, rows, maps, M, Minv, qvel, qs, x0):
    """`cg_full_noeuler_plain` as it was written before the solve became a
    parameter."""
    Jc = cg_kernel.contact_rows(rows["off1"], rows["off2"], rows["frame"], rows["fric"],
                                rows["m1"], rows["m2"], rows["cdof"], nfacet)
    J = torch.cat([rows["Js"], Jc], dim=1)
    aref = -maps["bref"] * mv(J, qvel) - maps["kimp"] * maps["pos"]
    D = torch.where(maps["active"] > 0, 1.0 / maps["rcoef"], torch.zeros_like(maps["rcoef"]))
    Deq, Done, Dfr = constraint.kind_masked_D(kind, D)
    x, f = cg_kernel.cg_plain(J, aref, Deq, Done, Dfr, maps["floss"], M, Minv, qs, x0, iterations)
    return x, f, mv(J.transpose(-1, -2), f)


def test_plain_solve_parameter_is_bit_identical(case):
    ci, its, nfacet = case
    a = _noeuler_args(ci, its, nfacet)
    want = _noeuler_as_before(*a)
    for got in (cg_kernel.cg_full_noeuler_plain(*a),
                cg_kernel.cg_full_noeuler_plain(*a, solve=cg_kernel.cg_plain)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert bool((want[1] != 0).any()), "no live row"


def test_solve_parameter_takes_the_solve(case):
    """`solve` gets `cg_plain`'s arguments and its result is the one
    returned, in `cg_full_plain` too."""
    ci, its, nfacet = case
    calls = []

    def solve(*args):
        calls.append(args)
        return cg_kernel.cg_plain(*args)

    a = chip_smoke.cg_args(ci, its, nfacet)
    got = cg_kernel.cg_full_plain(*a, solve=solve)
    want = cg_kernel.cg_full_plain(*a)
    assert len(calls) == 1 and calls[0][-1] == its and calls[0][0].shape[1] == len(ci["kind"])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_wrappers_take_the_plain_version_on_cpu(case):
    ci, its, nfacet = case
    a = chip_smoke.cg_args(ci, its, nfacet)
    assert all(torch.equal(g, w) for g, w in zip(cg_kernel.cg_full(*a), cg_kernel.cg_full_plain(*a)))
    n = _noeuler_args(ci, its, nfacet)
    assert all(torch.equal(g, w) for g, w in zip(cg_kernel.cg_full_noeuler(*n),
                                                  cg_kernel.cg_full_noeuler_plain(*n)))
    s = (*cg_kernel.solve_inputs(ci["kind"], nfacet, ci["rows"], ci["maps"], ci["qvel"]),
         *n[5:7], *n[8:10], its)
    assert all(torch.equal(g, w) for g, w in zip(cg_kernel.cg(*s), cg_kernel.cg_plain(*s)))
