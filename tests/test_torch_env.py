"""The port's env layer against the JAX package's, on the CPU: the rotation
additions, the tracker, the divergence guard, the hand's position control,
the cube functions and goal sampling, and the locked env itself (its
settle, `reset_physics` and `step`) on the dactyl-shaped world
(`robogym_torch/worlds/dactyl_locked_like.py`, nv = 36).

The JAX side runs at float32 under `jax.vmap`, its box-box pairs through
its Pallas kernel in interpret mode (`jax_boxbox_kernel`), and its env is
built on the stand-in world by pointing `build_cube_world_xml`, in this
process only, at the world's XML. Random draws are made from the JAX keys
(the same splits as the JAX functions make) and fed to the port's apply
functions, so both packages run the same episode. States cross by
`robogym_torch.bridge.env_state_to_numpy` / `env_state_from_numpy`."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (CUBE_POS_TOL, QPOS_TOL, QVEL_TOL, assert_physics_close,
                           jax_boxbox_kernel, jax_data_from_numpy, nudged_runs)
from robogym_torch import bridge
from robogym_torch.envs import core as t_core
from robogym_torch.envs.dactyl import cube_env as t_cube
from robogym_torch.envs.dactyl import locked as t_locked
from robogym_torch.robot import shadow_hand as t_hand
from robogym_torch.utils import rotation as t_rot
from robogym_torch.worlds import dactyl_locked_like
from robogym_tpu.envs import core as j_core
from robogym_tpu.envs.dactyl import cube_env as j_cube
from robogym_tpu.envs.dactyl import locked as j_locked
from robogym_tpu.robot import shadow_hand as j_hand
from robogym_tpu.utils import rotation as j_rot

B = 4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _unit_quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# rotation additions
# ---------------------------------------------------------------------------

def test_rotation_additions_match_jax():
    """quat_difference, quat_magnitude, vectors2quat (an antiparallel pair
    among them) and uniform_quat on the JAX keys' draws, on 64 seeded
    inputs, to 1e-6 abs in float32; the 24 parallel quaternions equal."""
    rng = np.random.default_rng(0)
    q, p = _unit_quats(rng, 64), _unit_quats(rng, 64)
    a = rng.standard_normal((64, 3)).astype(np.float32)
    b = rng.standard_normal((64, 3)).astype(np.float32)
    b[0] = -2.0 * a[0]
    for got, want in (
        (t_rot.quat_difference(_t(q), _t(p)), j_rot.quat_difference(q, p)),
        (t_rot.quat_magnitude(_t(q)), j_rot.quat_magnitude(q)),
        (t_rot.vectors2quat(_t(a), _t(b)), j_rot.vectors2quat(a, b)),
    ):
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(3), 64)
    want = jax.vmap(j_rot.uniform_quat)(keys)
    u = np.stack([_uniform_quat_u(k) for k in keys])
    np.testing.assert_allclose(_np(t_rot.uniform_quat_apply(_t(u))), np.asarray(want),
                               rtol=0, atol=1e-6)
    gen = torch.Generator().manual_seed(0)
    qs = t_rot.uniform_quat(gen, 64)
    np.testing.assert_allclose(_np(t_rot.norm(qs)), 1.0, atol=1e-6)
    assert bool((qs[:, 0] >= 0).all())
    np.testing.assert_array_equal(t_rot.get_parallel_rotations(), j_rot.get_parallel_rotations())


def _uniform_quat_u(key):
    """The three uniform draws of the JAX `uniform_quat(key)`."""
    return np.asarray([jax.random.uniform(k) for k in jax.random.split(key, 3)])


# ---------------------------------------------------------------------------
# tracker
# ---------------------------------------------------------------------------

def _jax_tracker(tr):
    return j_core.TrackerState(**{f.name: jnp.asarray(_np(getattr(tr, f.name)))
                                  for f in dataclasses.fields(t_core.TrackerState)})


def test_tracker_matches_jax():
    """60 steps at B=16 of seeded success patterns (successes in runs,
    `solved` now and then), hold durations of 1 to 3 steps, a 7-step goal
    timeout and 3 successes a trial: every tracker field, the success
    reward, done, need_new_goal and the info keys, integers and booleans
    exactly, floats to 1e-6."""
    cst = j_core.EnvConstants(max_timesteps_per_goal=7, successes_needed=3)
    tcst = t_core.EnvConstants(max_timesteps_per_goal=7, successes_needed=3)
    Bt = 16
    rng = np.random.default_rng(0)
    tr = t_core.TrackerState.zero(Bt).replace(
        success_steps_required=_t(rng.integers(1, 4, Bt).astype(np.int32)))
    jtr = _jax_tracker(tr)
    process = jax.vmap(lambda t, s, v: j_core.tracker_process(t, cst, s, v))
    info = jax.vmap(lambda t: j_core.tracker_info(t, cst))
    on = rng.random(Bt) < 0.5
    seen_trial = seen_resample = False
    for step in range(60):
        on = np.where(rng.random(Bt) < 0.3, ~on, on)
        solved = rng.random(Bt) < 0.03
        got = t_core.tracker_process(tr, tcst, _t(on), _t(solved))
        want = process(jtr, jnp.asarray(on), jnp.asarray(solved))
        tr, jtr = got[0], want[0]
        seen_trial |= bool(_np(tr.trial_success).any())
        seen_resample |= bool(_np(got[3]).any())
        for f in dataclasses.fields(t_core.TrackerState):
            np.testing.assert_array_equal(_np(getattr(tr, f.name)), np.asarray(getattr(jtr, f.name)),
                                          err_msg=f"{f.name} at step {step}")
        for g, w in zip(got[1:], want[1:]):
            np.testing.assert_array_equal(_np(g).astype(np.float64), np.asarray(w, np.float64))
        ti, ji = t_core.tracker_info(tr, tcst), info(jtr)
        assert sorted(ti) == sorted(ji)
        for k in ti:
            np.testing.assert_allclose(_np(ti[k]).astype(np.float64), np.asarray(ji[k], np.float64),
                                       rtol=0, atol=1e-6, err_msg=k)
    assert seen_trial and seen_resample


# ---------------------------------------------------------------------------
# the world, the port's env on the CPU, the JAX env on the stand-in world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_env():
    return t_locked.make_env(device="cpu", seed=0)


@pytest.fixture(scope="module")
def jax_env(tmp_path_factory):
    """The JAX LockedEnv on the stand-in world: `build_cube_world_xml`
    returns the world's XML while the env is built."""
    xml = dactyl_locked_like.write(str(tmp_path_factory.mktemp("dactyl")))
    orig = j_cube.build_cube_world_xml
    j_cube.build_cube_world_xml = lambda *a, **kw: xml
    try:
        with jax_boxbox_kernel():
            return j_locked.LockedEnv(j_locked.LockedEnvConstants(), dtype=jnp.float32)
    finally:
        j_cube.build_cube_world_xml = orig


@pytest.fixture(scope="module")
def jax_reset(jax_env):
    """The JAX env reset at B from seeded keys: (keys, state, obs)."""
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    with jax_boxbox_kernel():
        state, obs = jax.jit(jax.vmap(jax_env.reset))(keys)
    return keys, state, obs


def _attempt_draws(key):
    """(wiggle, quat u, action u) of one JAX reset attempt from its key."""
    k1, k2 = jax.random.split(key)
    k_pos, k_quat = jax.random.split(k1)
    return (np.asarray(jax.random.normal(k_pos, (3,), jnp.float32)), _uniform_quat_u(k_quat),
            np.asarray(jax.random.uniform(k2, (20,), jnp.float32)))


def jax_reset_draws(keys, n_attempts):
    """The port's `reset` draws from the JAX reset keys: (attempts,
    draws), the attempts as `CubeEnvBase.reset_physics` takes them."""
    per_env = []
    for key in keys:
        k_phys, k_goal, k_pause, _, _ = jax.random.split(key, 5)
        k, k0 = jax.random.split(k_phys)
        att = [_attempt_draws(k0)]
        for _ in range(n_attempts - 1):
            k, ki = jax.random.split(k)
            att.append(_attempt_draws(ki))
        per_env.append((att, _goal_draws(k_goal, k_pause)))
    attempts = [dict(wiggle=_t(np.stack([e[0][i][0] for e in per_env])),
                     quat=_t(np.stack([e[0][i][1] for e in per_env])),
                     action=_t(np.stack([e[0][i][2] for e in per_env])))
                for i in range(n_attempts)]
    return attempts, _stack_draws([e[1] for e in per_env])


def _goal_draws(k_goal, k_pause):
    kz, kp = jax.random.split(k_goal)
    return dict(goal_u=np.float32(jax.random.uniform(kz, (), jnp.float32)),
                goal_choice=np.int64(jax.random.randint(kp, (), 0, 24)),
                pause_u=np.float32(jax.random.uniform(k_pause, ())))


def _stack_draws(ds):
    return {k: _t(np.stack([d[k] for d in ds])) for k in ds[0]}


def jax_step_draws(state):
    """The port's `step` draws from the JAX state's keys."""
    out = []
    for key in np.asarray(state.key):
        _, k_goal, k_pause = jax.random.split(jnp.asarray(key), 3)
        out.append(_goal_draws(k_goal, k_pause))
    return _stack_draws(out)


def jax_env_state(arrays, keys):
    """The JAX package's batched EnvState from an `env_state_to_numpy`
    dict and PRNG keys."""
    def group(prefix):
        return {k[len(prefix):]: jnp.asarray(v) for k, v in arrays.items() if k.startswith(prefix)}

    physics = jax_data_from_numpy({k[8:]: v for k, v in arrays.items()
                                   if k.startswith("physics.")})
    tracker = j_core.TrackerState(**{f.name: jnp.asarray(arrays["tracker." + f.name])
                                     for f in dataclasses.fields(j_core.TrackerState)})
    return j_core.EnvState(physics=physics, goal=group("goal."),
                           goal_aux=jnp.asarray(arrays["goal_aux"]),
                           prev_goal_distance=group("prev_goal_distance."), tracker=tracker,
                           key=jnp.asarray(keys), t=jnp.asarray(arrays["t"]))


# ---------------------------------------------------------------------------
# hand, cube and guard functions
# ---------------------------------------------------------------------------

def test_hand_and_cube_index_bind(port_env, jax_env):
    assert dataclasses.asdict(port_env.hand).keys() == dataclasses.asdict(jax_env.hand).keys()
    for f in dataclasses.fields(t_hand.HandIndex):
        np.testing.assert_array_equal(np.asarray(getattr(port_env.hand, f.name)),
                                      np.asarray(getattr(jax_env.hand, f.name)))
    for f in dataclasses.fields(t_cube.CubeIndex):
        np.testing.assert_array_equal(np.asarray(getattr(port_env.cube, f.name)),
                                      np.asarray(getattr(jax_env.cube, f.name)))
    c = port_env.model.const
    assert (c.nq, c.nv) == (38, 36)
    np.testing.assert_array_equal(t_hand.POSITION_TO_CONTROL_MATRIX,
                                  j_hand.POSITION_TO_CONTROL_MATRIX)
    np.testing.assert_array_equal(t_cube.PARALLEL_QUATS, j_cube.PARALLEL_QUATS)


@pytest.mark.parametrize("relative,max_change", [(False, None), (True, None), (True, 0.1)])
def test_denormalize_position_control_matches_jax(port_env, jax_env, jax_reset, relative,
                                                  max_change):
    """Absolute and relative actions (and a capped relative step) on the
    reset states, to 1e-6 abs."""
    _, state, _ = jax_reset
    d = bridge.data_from_numpy(bridge.data_to_numpy(state.physics), "cpu")
    action = np.random.default_rng(2).uniform(-1.2, 1.2, (B, 20)).astype(np.float32)
    got = t_hand.denormalize_position_control(port_env.hand, port_env.model, d, _t(action),
                                              relative_action=relative,
                                              max_position_change=max_change)
    want = jax.vmap(lambda dd, a: j_hand.denormalize_position_control(
        jax_env.hand, jax_env.model, dd, a, relative_action=relative,
        max_position_change=max_change))(state.physics, jnp.asarray(action))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)
    limits = np.asarray([[-0.5, 2.0]] * 20, np.float32)
    for name in ("normalize_by_limits", "denormalize_by_limit"):
        np.testing.assert_allclose(_np(getattr(t_hand, name)(_t(action), _t(limits))),
                                   np.asarray(getattr(j_hand, name)(action, limits)),
                                   rtol=0, atol=1e-6)


def test_cube_functions_match_jax(port_env, jax_env, jax_reset):
    """cube_pos, cube_quat, is_on_palm, the up-axis functions,
    uniform_z_aligned_quat and sample_parallel_goal_quat on the JAX keys'
    draws, and relative_fingertip_positions, on the reset states and 64
    seeded quaternions, to 1e-6 abs (up-axis indices and signs exactly)."""
    _, state, _ = jax_reset
    d = bridge.data_from_numpy(bridge.data_to_numpy(state.physics), "cpu")
    jd = state.physics
    for name in ("cube_pos", "cube_quat", "is_on_palm"):
        np.testing.assert_allclose(_np(getattr(t_cube, name)(port_env.cube, d)),
                                   np.asarray(jax.vmap(lambda x: getattr(j_cube, name)(
                                       jax_env.cube, x))(jd)), rtol=0, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(
        _np(t_cube.relative_fingertip_positions(port_env.hand, port_env.model, d)),
        np.asarray(jax.vmap(lambda x: j_cube.relative_fingertip_positions(
            jax_env.hand, jax_env.model, x))(jd)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(t_hand.fingertip_positions(port_env.hand, d)),
                               np.asarray(jax.vmap(lambda x: j_hand.fingertip_positions(
                                   jax_env.hand, x))(jd)), rtol=0, atol=1e-6)
    q = _unit_quats(np.random.default_rng(4), 64)
    ax, sg = t_cube.up_axis_with_sign(_t(q))
    jax_ax, jax_sg = jax.vmap(j_cube.up_axis_with_sign)(q)
    np.testing.assert_array_equal(_np(ax), np.asarray(jax_ax))
    np.testing.assert_array_equal(_np(sg), np.asarray(jax_sg))
    np.testing.assert_allclose(_np(t_cube.align_quat_up(_t(q))),
                               np.asarray(jax.vmap(j_cube.align_quat_up)(q)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        _np(t_cube.distance_quat_from_being_up(_t(q), ax, sg)),
        np.asarray(jax.vmap(j_cube.distance_quat_from_being_up)(q, jax_ax, jax_sg)),
        rtol=0, atol=1e-6)
    keys = jax.random.split(jax.random.PRNGKey(5), 64)
    u = np.stack([np.float32(jax.random.uniform(k, (), jnp.float32)) for k in keys])
    np.testing.assert_allclose(
        _np(t_cube.uniform_z_aligned_quat(_t(u))),
        np.asarray(jax.vmap(lambda k: j_cube.uniform_z_aligned_quat(k, jnp.float32))(keys)),
        rtol=0, atol=1e-6)
    draws = _stack_draws([_goal_draws(k, k) for k in keys])
    np.testing.assert_allclose(
        _np(t_cube.sample_parallel_goal_quat(draws["goal_u"], draws["goal_choice"])),
        np.asarray(jax.vmap(lambda k: j_cube.sample_parallel_goal_quat(k, jnp.float32))(keys)),
        rtol=0, atol=1e-6)


def _assert_valid_goal(goal):
    """Each goal (n, 4) is a rotation about z times one of the 24 parallel
    quaternions: for some parallel p, goal * p^-1 has no x or y part."""
    goal = np.asarray(goal, np.float64)
    par = t_cube.PARALLEL_QUATS
    z = t_rot.quat_mul(torch.as_tensor(goal)[:, None], t_rot.quat_conjugate(torch.as_tensor(par))[None])
    off = np.abs(_np(z)[..., 1:3]).max(-1).min(-1)
    assert (off < 1e-6).all(), off
    np.testing.assert_allclose(np.linalg.norm(goal, axis=-1), 1.0, atol=1e-6)


def test_parallel_goals_are_valid():
    """The port's goals from its own generator: each a z-rotation times a
    parallel quat, and every one of the 24 chosen in 2000 draws."""
    gen = torch.Generator().manual_seed(0)
    u, choice = t_cube.draw_parallel_goal(gen, 2000)
    _assert_valid_goal(_np(t_cube.sample_parallel_goal_quat(u, choice)))
    assert len(set(_np(choice).tolist())) == 24


def test_divergence_guard_matches_jax(jax_reset):
    """One env with a NaN in qpos and one with an exploding qvel keep their
    pre-step physics over every field, contact set included; the rest take
    the new state, as the JAX package's tree_map picks."""
    _, state, _ = jax_reset
    prev = bridge.data_to_numpy(state.physics)
    new = {k: v + np.asarray(0.5, v.dtype) if v.dtype.kind == "f" else ~v if v.dtype == bool
           else v + 1 for k, v in prev.items()}
    new["qpos"][1, 3] = np.nan
    new["qvel"][2, 0] = 2e6
    got, bad = t_core.divergence_guard(bridge.data_from_numpy(prev, "cpu"),
                                       bridge.data_from_numpy(new, "cpu"))
    jgot, jbad = jax.vmap(j_core.divergence_guard)(jax_data_from_numpy(prev),
                                                   jax_data_from_numpy(new))
    np.testing.assert_array_equal(_np(bad), np.asarray(jbad))
    np.testing.assert_array_equal(_np(bad), [False, True, True, False])
    td, jd = bridge.data_to_numpy(got), bridge.data_to_numpy(jgot)
    assert sorted(td) == sorted(jd)
    for k in td:
        np.testing.assert_array_equal(td[k], jd[k], err_msg=k)
        np.testing.assert_array_equal(td[k][1:3], prev[k][1:3], err_msg=k)


# ---------------------------------------------------------------------------
# the locked env
# ---------------------------------------------------------------------------

def test_settle_matches_jax(port_env, jax_env):
    """The zero-control settle computed once at construction (200
    substeps), against the JAX env's `_settled_data`: the env-step
    envelope."""
    td = bridge.data_to_numpy(port_env._settled_data)
    jd = {k: v[None] for k, v in bridge.data_to_numpy(jax_env._settled_data).items()}
    assert_physics_close(td, jd, port_env.cube)
    assert bool(_np(t_cube.is_on_palm(port_env.cube, port_env._settled_data)).all())


def test_reset_physics_matches_jax(port_env, jax_env, jax_reset):
    """`reset_physics` on the draws of the JAX reset keys, against the JAX
    `reset_physics` on those keys (the state the JAX reset starts from).
    The warmup runs 100 substeps, ten env steps, with a cube dropped at a
    random orientation and tumbling on the palm, past the horizon of the
    env-step envelope: the batch's largest drift from JAX per group is
    held to twice its largest drift under a nudge of the settled state's
    qvel by 1e-6 (`assert_physics_close`, the rule of test_torch_step.py's
    goal settles); the same envs end on the palm."""
    keys, state, _ = jax_reset
    attempts, _ = jax_reset_draws(keys, port_env.constants.max_pose_resets + 1)
    d = port_env.reset_physics(B, attempts)
    td, jd = bridge.data_to_numpy(d), bridge.data_to_numpy(state.physics)
    base = port_env._settled_data

    def run(qvel):
        port_env._settled_data = base.replace(qvel=qvel)
        try:
            return bridge.data_to_numpy(port_env.reset_physics(B, attempts))
        finally:
            port_env._settled_data = base

    assert_physics_close(td, jd, port_env.cube, nudged_runs(run, base.qvel), whole=True)
    np.testing.assert_array_equal(_np(t_cube.is_on_palm(port_env.cube, d)),
                                  np.asarray(jax.vmap(lambda x: j_cube.is_on_palm(
                                      jax_env.cube, x))(state.physics)))


def _compare_step(tout, jout, idx, goal=True, nudged=()):
    """The port's step outputs against the JAX package's: physics within
    the env-step envelope (`assert_physics_close`, with the port's
    `nudged` step outputs for its chaotic envs); on the other envs, obs,
    rewards and distances within the tolerances that envelope gives them
    (see `test_step_matches_jax`); tracker fields, done and the info's
    integers and booleans exactly."""
    (ts, tobs, trew, tdone, tinfo), (js, jobs, jrew, jdone, jinfo) = tout, jout
    calm = ~assert_physics_close(bridge.data_to_numpy(ts.physics),
                                  bridge.data_to_numpy(js.physics), idx,
                                  [bridge.data_to_numpy(n[0].physics) for n in nudged])
    for k in tobs:
        if k in ("goal_quat", "is_goal_achieved") and not goal:
            continue
        tol = {"cube_pos": CUBE_POS_TOL, "qvel": QVEL_TOL, "fingertip_pos": 2e-3}.get(k, QPOS_TOL)
        tol = ANGLE_TOL if k in ("cube_quat",) else tol
        np.testing.assert_allclose(_np(tobs[k])[calm], np.asarray(jobs[k])[calm], rtol=0, atol=tol,
                                   err_msg=k)
    np.testing.assert_allclose(_np(trew)[calm], np.asarray(jrew)[calm], rtol=0, atol=2 * ANGLE_TOL)
    np.testing.assert_array_equal(_np(tdone), np.asarray(jdone))
    for k in tinfo:
        t, j = _np(tinfo[k]), np.asarray(jinfo[k])
        if t.dtype.kind == "f":
            np.testing.assert_allclose(t[calm], j[calm], rtol=0,
                                       atol=ANGLE_TOL if k == "goal_dist" else 1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(t, j, err_msg=k)
    for f in dataclasses.fields(t_core.TrackerState):
        np.testing.assert_array_equal(_np(getattr(ts.tracker, f.name)),
                                      np.asarray(getattr(js.tracker, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(_np(ts.t), np.asarray(js.t))
    if goal:
        np.testing.assert_allclose(_np(ts.goal["cube_quat"]), np.asarray(js.goal["cube_quat"]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(_np(ts.prev_goal_distance["cube_quat"])[calm],
                                   np.asarray(js.prev_goal_distance["cube_quat"])[calm], rtol=0,
                                   atol=ANGLE_TOL)


# A quaternion entry within QPOS_TOL of the reference moves the rotation by
# at most about 2 * QPOS_TOL * sqrt(4) rad; a distance (a rotation angle)
# and the goal-distance reward (a difference of two distances) follow at
# ANGLE_TOL and twice that. Near the identity, arccos would amplify the
# entries' error, but the envelope holds the angles away from there.
ANGLE_TOL = 4 * QPOS_TOL


@pytest.fixture(scope="module")
def jax_step(jax_env):
    step = jax.jit(jax.vmap(jax_env.step))

    def run(state, action):
        with jax_boxbox_kernel():
            return step(state, action)

    return run


def test_step_matches_jax(port_env, jax_env, jax_reset, jax_step):
    """Two env steps at B=4 from the JAX reset state carried across by the
    bridge, with the same actions and the JAX keys' draws: the physics
    within the env-step envelope (cube position 2e-4 m, qpos 1e-3, qvel
    5e-2 abs), the tracker exactly, and obs, rewards and distances within
    the tolerances that envelope gives them (ANGLE_TOL; the fingertips
    carry the joint angles' 1e-3 through links of 0.1 m at most, 2e-3)."""
    keys, jstate, jobs = jax_reset
    tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
    tobs = port_env._observe(tstate)
    for k in tobs:
        np.testing.assert_allclose(_np(tobs[k]), np.asarray(jobs[k]), rtol=0, atol=1e-6, err_msg=k)
    rng = np.random.default_rng(7)
    for _ in range(2):
        action = rng.uniform(-1, 1, (B, 20)).astype(np.float32)
        tout = port_env.step(tstate, _t(action), draws=jax_step_draws(jstate))
        jout = jax_step(jstate, jnp.asarray(action))
        _compare_step(tout, jout, port_env.cube)
        tstate, jstate = tout[0], jout[0]


def test_step_goal_resample_matches_jax(port_env, jax_env, jax_reset, jax_step):
    """A state whose goal is each env's cube orientation after the step,
    with a hold of one step, so that every env reaches its goal and
    resamples it at the first step: with the JAX keys' draws every output
    matches as in `test_step_matches_jax`; with the port's own draws every
    output but the new goal (and what depends on it) matches, and each new
    goal is a z-rotation times a parallel quat. This step's action moves
    one env across a discontinuity (its own runs from start qvels nudged by
    1e-6 leave the envelope), which is held by the nudge rule
    (`assert_physics_close`)."""
    keys, jstate, _ = jax_reset
    action = np.random.default_rng(8).uniform(-1, 1, (B, 20)).astype(np.float32)
    after = jax_step(jstate, jnp.asarray(action))[0]
    goal = jax.vmap(lambda d: j_cube.cube_quat(jax_env.cube, d))(after.physics)
    jstate = jstate.replace(goal={"cube_quat": goal})
    jout = jax_step(jstate, jnp.asarray(action))
    assert np.asarray(jout[4]["sub_goal_is_successful"]).all()
    assert (np.asarray(jout[0].tracker.goals_so_far) == 2).all()
    tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
    draws = jax_step_draws(jstate)

    def run(qvel):
        return port_env.step(tstate.replace(physics=tstate.physics.replace(qvel=qvel)),
                             _t(action), draws=draws)

    nudged = nudged_runs(run, tstate.physics.qvel)
    _compare_step(port_env.step(tstate, _t(action), draws=draws), jout, port_env.cube,
                  nudged=nudged)
    own = port_env.step(tstate, _t(action))
    _compare_step(own, jout, port_env.cube, goal=False, nudged=nudged)
    _assert_valid_goal(_np(own[0].goal["cube_quat"]))
    assert not np.allclose(_np(own[0].goal["cube_quat"]), _np(goal))
