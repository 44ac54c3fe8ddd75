"""The port's physics substep against the JAX package's: one substep on
the locked-like world and on BALL_BOX (<= 1e-4 abs on qpos and qvel), and a
10-substep env step on the locked-like world at B=4, which must stay inside
a stated envelope."""

import jax
import numpy as np
import pytest

from _torch_common import (ball_box_models, ball_box_state, locked_like_models,
                           locked_like_state, to_jax)
from robogym_torch import bridge
from robogym_torch.physics import step as t_step
from robogym_tpu.physics import step as j_step

B = 4
CUBE_QPOS = slice(24, 31)   # the locked-like world's free joint: pos (3), quat (4)


_JAX_STEPS = {}


def _jax_step(jmod):
    """The JAX package's jitted, vmapped substep, compiled once per model."""
    if id(jmod) not in _JAX_STEPS:
        _JAX_STEPS[id(jmod)] = jax.jit(jax.vmap(lambda x: j_step.step(jmod, x)))
    return _JAX_STEPS[id(jmod)]


def _one_substep(jmod, tm, d):
    jd = bridge.data_to_numpy(_jax_step(jmod)(to_jax(d)))
    td = bridge.data_to_numpy(t_step.step(tm, d))
    for k in ("qpos", "qvel"):
        assert np.isfinite(td[k]).all()
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=1e-4, err_msg=k)
    assert td["contact.active"].any()


@pytest.mark.parametrize("seed", [0, 1])
def test_one_substep_matches_jax_locked_like(seed):
    jmod, tm = locked_like_models()
    _one_substep(jmod, tm, locked_like_state(tm, B, seed=seed))


def test_one_substep_matches_jax_ball_box():
    jmod, tm = ball_box_models()
    _one_substep(jmod, tm, ball_box_state(tm, 3))


def test_env_step_matches_jax_locked_like():
    """One env step: 10 substeps, as `envs/core.py` runs them (the JAX side
    loops its jitted substep, which is what its `step_n` scans). The CG
    leaves float32 noise in the contact forces (see test_torch_kernels) and
    ten substeps carry it into the state; on this state the JAX package's
    float32 qvel differs by 2e-2 from a float64 run of the port, with
    finger joints at up to 15 rad/s. Envelope: 2e-4 m on the cube's
    position, 1e-3 on its quaternion and every other qpos, 5e-2 abs on
    every qvel."""
    jmod, tm = locked_like_models()
    d = locked_like_state(tm, B, seed=2)
    jd = to_jax(d)
    for _ in range(10):
        jd = _jax_step(jmod)(jd)
    jd = bridge.data_to_numpy(jd)
    td = bridge.data_to_numpy(t_step.step_n(tm, d, 10))
    assert np.isfinite(td["qpos"]).all() and np.isfinite(td["qvel"]).all()
    cube_t, cube_j = td["qpos"][:, CUBE_QPOS], jd["qpos"][:, CUBE_QPOS]
    np.testing.assert_allclose(cube_t[:, :3], cube_j[:, :3], rtol=0, atol=2e-4)
    np.testing.assert_allclose(td["qpos"], jd["qpos"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(td["qvel"], jd["qvel"], rtol=0, atol=5e-2)
