"""The port's unfused dynamics against the JAX package's: `make_efc`,
`solve`, `forward_tail`, `euler` and `forward`, on the locked-like world
(contact slots: the post-gather CG core without the Euler update), its
hand-only variant (no collision pair: `make_efc` and the CG solve on its J,
kernel F's path) and BALL_BOX (contact slots, no scalar row).

Each function gets the same state in both packages, carried across as
numpy. Tolerances, relative to each output's largest value: J, aref and D
1e-5 (the same float32 formulas); the solve's qacc 1e-4 and its contact
forces 1e-2 where contacts are live (15 unconverged CG iterations with a
discrete line search carry float32's last-bit noise into the small row
forces; see tests/test_torch_kernels.py), 1e-5 on the contactless hand,
where the live rows are a handful of joint limits; forward() as stated at
FORWARD_TOL; euler's qpos and qvel 1e-5 abs."""

import jax
import numpy as np
import pytest
import torch

from _torch_common import (ball_box_models, ball_box_state, hand_state, locked_like_models,
                           locked_like_state, snapshot_jax_model, to_jax)
from robogym_torch import bridge
from robogym_torch.physics import constraint as t_con
from robogym_torch.physics import factor_kernel
from robogym_torch.physics import step as t_step
from robogym_torch.worlds import locked_like
from robogym_tpu.physics import constraint as j_con
from robogym_tpu.physics import step as j_step

B = 4
WORLDS = ("locked_like", "hand", "ball_box")
SOLVE_TOL = {"locked_like": (1e-4, 1e-2), "hand": (1e-5, 1e-5), "ball_box": (1e-4, 1e-2)}
# forward() runs each package's own collision and smooth phase, so the
# solve starts from inputs that differ in their last bits, which the CG
# amplifies: on the locked-like world at B=4, seeds 0 to 3 give qacc 6e-6
# to 3.5e-4 and qfrc 8e-5 to 5.9e-3 relative
FORWARD_TOL = {"locked_like": (1e-3, 2e-2), "hand": (1e-5, 1e-5), "ball_box": (1e-3, 2e-2)}


def _world(name):
    """(JAX Model, port Model, settled state)."""
    if name == "locked_like":
        jm, tm = locked_like_models()
        return jm, tm, locked_like_state(tm, B, seed=0)
    if name == "hand":
        return (snapshot_jax_model(locked_like.HAND_SNAPSHOT),) + hand_state(B, seed=0)
    jm, tm = ball_box_models()
    return jm, tm, ball_box_state(tm, B)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _smooth(tm, d):
    """The state up to the constraint solve, with qacc_smooth filled by
    the plain SPD inverse, and (qfrc_smooth, Minv)."""
    d, qfrc_smooth = t_step.forward_smooth(tm, d)
    Minv = factor_kernel.spd_inverse_plain(d.qM)
    qs = torch.matmul(Minv, qfrc_smooth.unsqueeze(-1)).squeeze(-1)
    return d.replace(qacc_smooth=qs), qfrc_smooth, Minv


def _vmap(fn, *args):
    return jax.jit(jax.vmap(fn))(*args)


@pytest.mark.parametrize("world", WORLDS)
def test_make_efc_matches_jax(world):
    jm, tm, d = _world(world)
    d, _, _ = _smooth(tm, d)
    got = t_con.make_efc(tm, d)
    keys = ("J", "aref", "D", "floss")

    def one(x):
        efc = j_con.make_efc(jm, x)
        sel = efc["contact_sel"]
        return tuple(efc[k] for k in keys) + ((sel,) if sel is not None else ())

    want = _vmap(one, to_jax(d))
    if world == "hand":
        assert got["contact_sel"] is None and got["n_scalar"] == 24
    else:
        np.testing.assert_array_equal(got["contact_sel"].numpy(), np.asarray(want[-1]))
    for k, w in zip(keys, want):
        assert _rel(got[k].numpy(), w) <= 1e-5, (k, _rel(got[k].numpy(), w))
    assert (got["D"] > 0).any(), "no live constraint row"


@pytest.mark.parametrize("world", WORLDS)
def test_solve_matches_jax(world):
    """`solve` and `forward_tail` from the same smooth state."""
    jm, tm, d = _world(world)
    d, qfrc_smooth, Minv = _smooth(tm, d)
    tol_qacc, tol_f = SOLVE_TOL[world]
    jd = to_jax(d)
    jq, jM = jax.numpy.asarray(qfrc_smooth.numpy()), jax.numpy.asarray(Minv.numpy())
    runs = [
        (t_con.solve(tm, d, Minv), _vmap(lambda x, q, M: j_con.solve(jm, x, q, M), jd, jq, jM)),
        (t_step.forward_tail(tm, d, qfrc_smooth),
         _vmap(lambda x, q: j_step.forward_tail(jm, x, q), jd, jq)),
    ]
    for td, wd in runs:
        td, wd = bridge.data_to_numpy(td), bridge.data_to_numpy(wd)
        assert np.isfinite(td["qacc"]).all()
        assert _rel(td["qacc"], wd["qacc"]) <= tol_qacc
        assert _rel(td["qacc_smooth"], wd["qacc_smooth"]) <= 1e-5
        for k in ("qfrc_constraint", "efc_force_contact"):
            if wd[k].size and np.abs(wd[k]).max() > 0:
                assert _rel(td[k], wd[k]) <= tol_f, (k, _rel(td[k], wd[k]))
    assert np.abs(bridge.data_to_numpy(runs[0][0])["qfrc_constraint"]).max() > 0


@pytest.mark.parametrize("world", WORLDS)
def test_euler_matches_jax(world):
    """`euler` from the same state with qacc filled (one refinement step of
    the implicit-damping inverse, then qpos integration)."""
    jm, tm, d = _world(world)
    d = t_step.forward(tm, d)
    td = bridge.data_to_numpy(t_step.euler(tm, d))
    wd = bridge.data_to_numpy(_vmap(lambda x: j_step.euler(jm, x), to_jax(d)))
    for k in ("qpos", "qvel"):
        np.testing.assert_allclose(td[k], wd[k], rtol=0, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_forward_matches_jax(world):
    """The whole of `forward` from the same state, each package running
    its own collision and smooth phase."""
    jm, tm, d = _world(world)
    tol_qacc, tol_f = FORWARD_TOL[world]
    td = bridge.data_to_numpy(t_step.forward(tm, d))
    wd = bridge.data_to_numpy(_vmap(lambda x: j_step.forward(jm, x), to_jax(d)))
    np.testing.assert_array_equal(td["qpos"], wd["qpos"])
    assert _rel(td["qacc"], wd["qacc"]) <= tol_qacc, _rel(td["qacc"], wd["qacc"])
    assert _rel(td["qfrc_constraint"], wd["qfrc_constraint"]) <= tol_f
