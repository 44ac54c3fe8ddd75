"""The port's physics substep against the JAX package's: one substep on
the locked-like world, on BALL_BOX, on the goal-settle world (box-box pairs,
no scalar row), on the table-setting world (box-mesh, mesh-mesh and
plane-mesh manifolds) and on the hand-only world (no contact slot: the
unfused `forward_tail` and `euler`), <= 1e-4 abs on qpos and qvel; a
10-substep env step on the locked-like world and a 40-substep env step on
each goal-settle world at B=4, which must stay inside stated envelopes."""

import jax
import numpy as np
import pytest
import torch

from _torch_common import (ball_box_models, ball_box_state, hand_state, jax_boxbox_kernel,
                           locked_like_models, locked_like_state, settle_state,
                           snapshot_jax_model, to_jax)
from robogym_torch import bridge
from robogym_torch.physics import step as t_step
from robogym_torch.worlds import blocks_settle_like, locked_like, table_setting_like
from robogym_tpu.physics import step as j_step

B = 4
CUBE_QPOS = slice(24, 31)   # the locked-like world's free joint: pos (3), quat (4)


_JAX_STEPS = {}


def _jax_step(jmod):
    """The JAX package's jitted, vmapped substep, compiled once per model,
    with box-box pairs through its Pallas kernel (`jax_boxbox_kernel`)."""
    if id(jmod) not in _JAX_STEPS:
        step = jax.jit(jax.vmap(lambda x: j_step.step(jmod, x)))

        def run(x):
            with jax_boxbox_kernel():
                return step(x)

        _JAX_STEPS[id(jmod)] = run
    return _JAX_STEPS[id(jmod)]


def _one_substep(jmod, tm, d, contacts=True):
    jd = bridge.data_to_numpy(_jax_step(jmod)(to_jax(d)))
    td = bridge.data_to_numpy(t_step.step(tm, d))
    for k in ("qpos", "qvel"):
        assert np.isfinite(td[k]).all()
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=1e-4, err_msg=k)
    assert td["contact.active"].any() == contacts


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


def test_one_substep_matches_jax_settle():
    _one_substep(snapshot_jax_model(blocks_settle_like.SNAPSHOT), *settle_state(B))


def test_one_substep_matches_jax_table_setting():
    _one_substep(snapshot_jax_model(table_setting_like.SNAPSHOT),
                 *settle_state(B, world=table_setting_like))


def test_one_substep_matches_jax_hand():
    _one_substep(snapshot_jax_model(locked_like.HAND_SNAPSHOT), *hand_state(B), contacts=False)


def _env_step_drift(world, top, envelope, start=10):
    """One env step of a goal settle, 40 substeps of 1 ms at B=4 from
    `start` substeps after the objects' start (10: still landing), port
    against JAX, for each seed. The port is also run from start qvels nudged by
    1e-6 (three draws), and per group of objects the drift from JAX is held
    to what a nudge gives: the largest error in quaternion, linear and
    angular velocity at most twice the largest nudged run's. Beside that,
    absolute envelopes: every object's position 2e-4 m, and per group
    (quaternion entries, m/s, rad/s) as `envelope` says. The drifts are
    printed (`-s`). `top` (B, 5) marks the objects resting on another
    object, the rest lie on the table: envelope {group: limits}, the
    table's group first."""
    jmod = snapshot_jax_model(world.SNAPSHOT)
    (on_table, table_lim), (stacked, stack_lim) = envelope.items()
    groups = {on_table: (~top, table_lim), stacked: (top, stack_lim)}
    for seed in (0, 1, 2):
        tm, d = settle_state(B, seed=seed, settle=start, world=world)
        jd = to_jax(d)
        for _ in range(40):
            jd = _jax_step(jmod)(jd)
        runs = {"JAX": bridge.data_to_numpy(jd)}
        td = bridge.data_to_numpy(t_step.step_n(tm, d, 40))
        assert np.isfinite(td["qpos"]).all() and np.isfinite(td["qvel"]).all()
        assert td["contact.active"].any()
        for k in range(3):
            nudge = 1e-6 * np.random.default_rng(5 + k).standard_normal(d.qvel.shape)
            dn = d.replace(qvel=d.qvel + torch.as_tensor(nudge.astype(np.float32)))
            runs[f"nudged port {k}"] = bridge.data_to_numpy(t_step.step_n(tm, dn, 40))
        drift = {}                            # run: {group: (pos, quat, lin, ang)}
        for name, other in runs.items():
            dq = np.abs(td["qpos"] - other["qpos"]).reshape(B, 5, 7)
            dv = np.abs(td["qvel"] - other["qvel"]).reshape(B, 5, 6)
            drift[name] = {g: tuple(float(x[..., sl][m_].max()) for x, sl in (
                (dq, slice(0, 3)), (dq, slice(3, 7)), (dv, slice(0, 3)), (dv, slice(3, 6))))
                for g, (m_, _) in groups.items()}
            for g, (pos, quat, lin, ang) in drift[name].items():
                print(f"{world.__name__.rsplit('.', 1)[-1]} seed {seed}, port vs {name}, {g}: "
                      f"position {pos:.3g} m, quaternion {quat:.3g}, velocity {lin:.3g} m/s, "
                      f"{ang:.3g} rad/s")
        for g, (_, limits) in groups.items():
            pos, *got = drift["JAX"][g]
            nudged = [max(drift[n][g][i + 1] for n in runs if n != "JAX") for i in range(3)]
            assert pos <= 2e-4, (seed, g, pos)
            for what, e, n, lim in zip(("quaternion", "velocity", "angular velocity"), got,
                                       nudged, limits):
                assert e <= 2 * n and e <= lim, (seed, g, what, e, n, lim)


def test_env_step_matches_jax_settle():
    """One env step of the goal settle: 40 substeps of 1 ms (a fifth of
    blocks.py's 5 x 40), from blocks still landing, for seeds 0 to 2. The
    one-substep test above is what holds the port's arithmetic to JAX (at
    1e-4): box-box contact points moved by a tenth of their depth fail it
    and pass this test. This one bounds the drift of a whole env step.
    Over 40 substeps the blocks' rocking on the table and on each other is
    chaotic (the table blocks' angular velocities drift by as much as
    they are), so the drift from JAX is held to what a nudge gives
    (`_env_step_drift`). Envelopes: the blocks on the table, quaternion
    entries 1e-3, linear velocity 1e-2 m/s, angular 0.4 rad/s; the stacked
    top block: 5e-3, 0.1 m/s and 5 rad/s."""
    top = np.zeros((B, 5), bool)
    top[1::2, 1] = True                       # block 1 of the odd envs starts on block 0
    _env_step_drift(blocks_settle_like, top, {"on the table": (1e-3, 1e-2, 0.4),
                                              "stacked top": (5e-3, 0.1, 5.0)})


def test_env_step_matches_jax_table_setting():
    """One env step of the table-setting goal settle, 40 substeps from the
    state 40 substeps after the start (the objects landed, the spoon on the
    plate in the odd envs), seeds 0 to 2, held as the blocks'
    (`_env_step_drift`). The spoon rests on the plate on one contact point
    (no plate vert lies under it, so the mesh-mesh manifold falls back to
    the sweep's witness) and tips, and the objects rock on their feet, so
    the step is chaotic: the port's drift from JAX reaches 1.79 times its
    largest nudged drift (seed 0, the table objects' quaternions, on the
    CPU). Envelopes, about three times the largest drift from JAX seen:
    the objects on the table, quaternion entries 2e-3, linear velocity
    2e-2 m/s, angular 0.2 rad/s; the spoon on the plate: 5e-3, 2e-2 m/s and
    1 rad/s."""
    top = np.zeros((B, 5), bool)
    top[1::2, table_setting_like.SPOON] = True
    _env_step_drift(table_setting_like, top, {"on the table": (2e-3, 2e-2, 0.2),
                                              "spoon on the plate": (5e-3, 2e-2, 1.0)},
                    start=40)
