"""The port's Newton constraint solve (`constraint.solve` under
`opt.solver == "newton"`) and a physics step on it against the JAX
package's, on the CPU, on the ball-and-box world and the locked-like world
(B=4, settled into contact by the port's CG step).

The JAX compiler reads no `solver` attribute, so both models are switched
by `replace(opt=...)`. One `forward()` (whose tail is the solve) is held
to 1e-4 of the largest entry of qacc and of qfrc_constraint; five
substeps by the nudge rule of `_torch_common.assert_physics_close` (the
line search's argmin over six float32 costs flips on near-ties, as the CG
line search does). A copy of the port's solver whose Hessian lacks its
J' diag(w) J term must fail the one-solve check."""

import dataclasses
import os
import types

import jax
import numpy as np
import pytest
import torch

from _torch_common import (assert_physics_close, ball_box_models, ball_box_state,
                           locked_like_models, locked_like_state, nudged_runs, to_jax)
from robogym_torch import bridge
from robogym_torch.physics import constraint as t_constraint
from robogym_torch.physics import step as t_step
from robogym_tpu.physics import step as j_step

B = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HESSIAN = "H = M + torch.matmul(Jt * w[:, None, :], J) + 1e-10 * eye"


def newton(jm, tm):
    return (jm.replace(opt=jm.opt.replace(solver="newton")),
            tm.replace(opt=dataclasses.replace(tm.opt, solver="newton")))


@pytest.fixture(scope="module", params=["ball_box", "locked_like"])
def world(request):
    """(name, JAX Model, port Model, both under Newton, start states)."""
    if request.param == "ball_box":
        jm, tm = ball_box_models()
        d = ball_box_state(tm, B)
    else:
        jm, tm = locked_like_models()
        d = locked_like_state(tm, B)
    return (request.param, *newton(jm, tm), d)


def _jax_forward(jm, d):
    return bridge.data_to_numpy(jax.jit(jax.vmap(lambda x: j_step.forward(jm, x)))(to_jax(d)))


def _assert_solve_close(got, want):
    for k in ("qacc", "qfrc_constraint"):
        scale = np.abs(want[k]).max()
        err = np.abs(got[k] - want[k]).max()
        assert np.isfinite(got[k]).all() and err <= 1e-4 * scale, (k, err, scale)


def test_one_solve_matches_jax(world):
    """forward(): the constraint rows live, qacc and qfrc_constraint to
    1e-4 of their largest entry, the contacts' normal forces as the JAX
    package's."""
    _, jm, tm, d = world
    got = bridge.data_to_numpy(t_step.forward(tm, d))
    want = _jax_forward(jm, d)
    assert t_constraint.make_efc(tm, t_step.forward_smooth(tm, d)[0])["D"].gt(0).any()
    _assert_solve_close(got, want)
    scale = np.abs(want["efc_force_contact"]).max()
    assert scale > 0
    np.testing.assert_allclose(got["efc_force_contact"], want["efc_force_contact"], rtol=0,
                               atol=1e-4 * scale)


def test_newton_step_takes_the_unfused_tail(world):
    """`solve_fused_step` declines a Newton model, so `step` runs
    `forward_tail` and `euler`, as the JAX step does (step.py:172-178)."""
    _, _, tm, d = world
    d1, qfrc_smooth = t_step.forward_smooth(tm, d)
    assert t_constraint.solve_fused_step(tm, d1, qfrc_smooth) is None
    want = t_step.euler(tm, t_step.forward_tail(tm, d1, qfrc_smooth))
    got = t_step.step(tm, d)
    for k in ("qpos", "qvel", "qacc"):
        assert torch.equal(getattr(got, k), getattr(want, k)), k


def test_newton_inverts_m_only_for_qacc_smooth_and_euler(world, monkeypatch):
    """Under Newton a substep inverts two matrices: M in `forward_tail`, for
    qacc_smooth, which the Newton gradient reads, and M_imp in `euler`.
    `solve` itself, called on its own, inverts none."""
    from robogym_torch.physics import factor_kernel

    _, _, tm, d = world
    calls = []
    inverse = factor_kernel.spd_inverse
    monkeypatch.setattr(factor_kernel, "spd_inverse", lambda A: calls.append(A) or inverse(A))
    d1, qfrc_smooth = t_step.forward_smooth(tm, d)
    t_constraint.solve(tm, d1.replace(qacc_smooth=torch.zeros_like(qfrc_smooth)))
    assert len(calls) == 0
    t_step.step(tm, d)
    assert len(calls) == 2


def test_five_substeps_match_jax(world):
    """Five Newton substeps by the nudge rule."""
    name, jm, tm, d = world
    td = bridge.data_to_numpy(t_step.step_n(tm, d, 5))
    jd = bridge.data_to_numpy(jax.jit(jax.vmap(lambda x: j_step.step_n(jm, x, 5)))(to_jax(d)))

    def run(qvel):
        return bridge.data_to_numpy(t_step.step_n(tm, d.replace(qvel=qvel), 5))

    idx = None
    if name == "locked_like":
        adr = int(tm.const.jnt_qposadr[tm.const.names["joint"]["cube_j"]])
        idx = types.SimpleNamespace(cube_pos_qpos=np.arange(adr, adr + 3))
    assert_physics_close(td, jd, idx, nudged_runs(run, d.qvel))


def _faulty_constraint():
    """A copy of the port's constraint module whose Newton Hessian is M
    alone."""
    path = os.path.join(REPO, "robogym_torch", "physics", "constraint.py")
    with open(path) as f:
        src = f.read()
    assert src.count(HESSIAN) == 1
    mod = types.ModuleType("constraint_without_jwj")
    mod.__file__ = path
    exec(compile(src.replace(HESSIAN, "H = M + 1e-10 * eye"), path, "exec"), mod.__dict__)
    return mod


def test_planted_fault_fails_the_solve_check(world):
    """The solve without J' diag(w) J in its Hessian leaves the one-solve
    tolerance: the check catches a wrong Hessian."""
    _, jm, tm, d = world
    faulty = _faulty_constraint()
    d1, qfrc_smooth = t_step.forward_smooth(tm, d)
    d1 = d1.replace(qacc_smooth=torch.linalg.solve(d1.qM, qfrc_smooth[..., None])[..., 0])
    got = bridge.data_to_numpy(faulty._solve_newton(tm, d1, faulty.make_efc(tm, d1)))
    sound = bridge.data_to_numpy(t_constraint._solve_newton(tm, d1, t_constraint.make_efc(tm, d1)))
    want = _jax_forward(jm, d)
    _assert_solve_close(sound, want)
    with pytest.raises(AssertionError):
        _assert_solve_close(got, want)
