"""The port's face-perpendicular Rubik's env against the JAX package's, on the
CPU at B=4: the rotation additions, the face env's index tables, face
angles, goal distance and goal generator, its construction's settle,
`reset_physics`, `reset` and `step`, the face-damping transform, and the
default dactyl stack with that transform around the env.

The JAX env is built on the cubelet stand-in world
(`robogym_torch/worlds/rubik_face_like.py`, nv = 48) by pointing
`face_perpendicular.build_face_world_xml`, in this process only, at the
world's XML, at float32, its box-box pairs through its Pallas kernel in
interpret mode (`jax_boxbox_kernel`). Random draws are made from the JAX
keys (the same splits as the JAX functions make) and fed to the port's
apply functions; where the JAX goal takes a uniform and a randint from one
key (`k_flip`), both of the port's draws come from that key. States cross
by `bridge.env_state_to_numpy` / `env_state_from_numpy`.

Tolerances: the rotation functions, the goal generator, face angles and
distances on the same states 1e-6 abs (goal types and branch booleans
exactly); the physics of the settle, the reset and each step by the
env-step envelope of `_torch_common.assert_physics_close` (cube position
2e-4 m, qpos 1e-3, qvel 5e-2) and its nudge rule; on the envs within the
envelope, obs, rewards and distances within the tolerances the envelope
gives them (as tests/test_torch_env.py holds the locked env's); tracker
fields, done and the info's integers and booleans exactly. The wrapped
env as tests/test_torch_wrappers.py holds the locked one's."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_wrappers as tw
from _torch_common import (CUBE_POS_TOL, QPOS_TOL, QVEL_TOL, _env_err, _groups,
                           NUDGE, assert_physics_close, jax_boxbox_kernel, nudged_runs,
                           snapshot_arrays)
from robogym_torch import bridge
from robogym_torch import wrappers as TW
from robogym_torch.envs import core as t_core
from robogym_torch.envs.dactyl import cube_env as t_cube
from robogym_torch.envs.dactyl import face_perpendicular as t_face
from robogym_torch.mjcf.model import make_data
from robogym_torch.physics import step as t_step
from robogym_torch.robot import shadow_hand as t_hand
from robogym_torch.utils import rotation as t_rot
from robogym_torch.worlds import rubik_face_like
from robogym_torch.wrappers.core import model_field
from robogym_tpu import wrappers as JW
from robogym_tpu.envs.dactyl import cube_env as j_cube
from robogym_tpu.envs.dactyl import face_perpendicular as j_face
from robogym_tpu.utils import rotation as j_rot

B = 4
split = jax.random.split
# a quaternion entry within QPOS_TOL moves a rotation by at most about
# 4 * QPOS_TOL rad (tests/test_torch_env.py)
ANGLE_TOL = 4 * QPOS_TOL
# a face-angle distance: the norm of two wrapped angles, each within QPOS_TOL
FACE_TOL = 2 * QPOS_TOL


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _close(got, want, tol=1e-6, msg=""):
    np.testing.assert_allclose(_np(got).astype(np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=tol, err_msg=msg)


def _unit_quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _euler_quats(euler):
    return np.asarray(j_rot.euler2quat(jnp.asarray(np.asarray(euler, np.float32))))


# ---------------------------------------------------------------------------
# rotation additions
# ---------------------------------------------------------------------------

def test_rotation_additions_match_jax():
    """round_to_straight_angles on seeded angles, on multiples of pi/4
    (half-way: half to even), on +-pi and on angles beyond +-2 pi (the
    wrap takes the divisor's sign); round_to_straight_quat and
    rot_z_aligned (with and without the flip) on seeded quats, z-rotations,
    flipped z-rotations and gimbal-lock inputs (pitch +-pi/2); 1e-6 abs,
    the booleans exactly."""
    rng = np.random.default_rng(0)
    f = np.float32
    angles = np.concatenate([
        rng.uniform(-8.0, 8.0, 64), np.arange(-8, 9) * f(np.pi / 4),
        [np.pi, -np.pi, f(np.pi), -f(np.pi), 0.0, -0.0, 7.0, -7.0]]).astype(f)
    _close(t_rot.round_to_straight_angles(_t(angles)), j_rot.round_to_straight_angles(angles))
    _close(t_rot.normalize_angles(_t(angles)), j_rot.normalize_angles(angles))
    yaw = rng.uniform(-np.pi, np.pi, 16)
    zero = np.zeros(16)
    lock = [[a, s * np.pi / 2, c] for a, s, c in zip(rng.uniform(-3, 3, 8), [1, -1] * 4,
                                                     rng.uniform(-3, 3, 8))]
    quats = np.concatenate([
        _unit_quats(rng, 64),
        _euler_quats(np.stack([zero, zero, yaw], 1)),                   # z-rotations
        _euler_quats(np.stack([zero + np.pi, zero, yaw], 1)),           # flipped
        _euler_quats(np.stack([rng.normal(0, 0.3, 16), rng.normal(0, 0.3, 16), yaw], 1)),
        _euler_quats(lock),                                             # gimbal lock
        _euler_quats([[np.pi / 4, 0, np.pi / 4], [0, np.pi / 4, -3 * np.pi / 4]]),  # half-way
    ]).astype(f)
    _close(t_rot.round_to_straight_quat(_t(quats)), j_rot.round_to_straight_quat(quats))
    for flip in (True, False):
        got = _np(t_rot.rot_z_aligned(_t(quats), 0.4, include_flip=flip))
        want = np.asarray(j_rot.rot_z_aligned(quats, 0.4, include_flip=flip))
        np.testing.assert_array_equal(got, want)
    assert got[64:80].all() and not got[80:96].any()


# ---------------------------------------------------------------------------
# the world, the port's env on the CPU, the JAX env on the stand-in world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_env():
    return t_face.make_env(device="cpu", seed=0)


@pytest.fixture(scope="module")
def jax_env(tmp_path_factory):
    """The JAX FacePerpendicularEnv on the stand-in world:
    `build_face_world_xml` returns the world's XML while the env is built."""
    xml = rubik_face_like.write(str(tmp_path_factory.mktemp("rubik")))
    orig = j_face.build_face_world_xml
    j_face.build_face_world_xml = lambda: xml
    try:
        with jax_boxbox_kernel():
            return j_face.FacePerpendicularEnv(j_face.FacePerpendicularEnvConstants(),
                                               dtype=jnp.float32)
    finally:
        j_face.build_face_world_xml = orig


def _uniform_quat_u(key):
    """The three uniform draws of the JAX `uniform_quat(key)`."""
    return np.asarray([jax.random.uniform(k) for k in split(key, 3)])


def _attempt_draws(key):
    """(wiggle, quat u, action u) of one JAX reset attempt from its key."""
    k1, k2 = split(key)
    k_pos, k_quat = split(k1)
    return (np.asarray(jax.random.normal(k_pos, (3,), jnp.float32)), _uniform_quat_u(k_quat),
            np.asarray(jax.random.uniform(k2, (20,), jnp.float32)))


def _goal_draws(k_goal, k_pause):
    """The port's `draw_step` draws from the JAX goal and hold keys: the
    flip decision and the flipped face both from `k_flip`."""
    k_flip, _, k_dir, k_z = split(k_goal, 4)
    return dict(flip_u=np.float32(jax.random.uniform(k_flip, (), jnp.float32)),
                direction=np.int64(jax.random.randint(k_dir, (), 0, 2)),
                face=np.int64(jax.random.randint(k_flip, (), 0, 2)),
                z_u=np.float32(jax.random.uniform(k_z, (), jnp.float32)),
                pause_u=np.float32(jax.random.uniform(k_pause, ())))


def _stack_draws(ds):
    return {k: _t(np.stack([d[k] for d in ds])) for k in ds[0]}


def jax_reset_draws(keys, n_attempts):
    """The port's `reset` draws from the JAX reset keys: (attempts, draws)."""
    per_env = []
    for key in keys:
        k_phys, k_goal, k_pause, _ = split(key, 4)
        k, k0 = split(k_phys)
        att = [_attempt_draws(k0)]
        for _ in range(n_attempts - 1):
            k, ki = split(k)
            att.append(_attempt_draws(ki))
        per_env.append((att, _goal_draws(k_goal, k_pause)))
    attempts = [dict(wiggle=_t(np.stack([e[0][i][0] for e in per_env])),
                     quat=_t(np.stack([e[0][i][1] for e in per_env])),
                     action=_t(np.stack([e[0][i][2] for e in per_env])))
                for i in range(n_attempts)]
    return attempts, _stack_draws([e[1] for e in per_env])


def jax_step_draws(keys):
    """The port's `step` draws from the JAX step keys (B, 2)."""
    out = []
    for key in np.asarray(keys):
        _, k_goal, k_pause = split(jnp.asarray(key), 3)
        out.append(_goal_draws(k_goal, k_pause))
    return _stack_draws(out)


@pytest.fixture(scope="module")
def jax_reset_fn(jax_env):
    """The JAX env's batched reset, compiled once for the module."""
    reset = jax.jit(jax.vmap(jax_env.reset))

    def run(keys):
        with jax_boxbox_kernel():
            return reset(keys)

    return run


@pytest.fixture(scope="module")
def jax_reset(jax_reset_fn):
    """The JAX env reset at B from seeded keys: (keys, state, obs)."""
    keys = split(jax.random.PRNGKey(11), B)
    return (keys, *jax_reset_fn(keys))


@pytest.fixture(scope="module")
def jax_step(jax_env):
    step = jax.jit(jax.vmap(jax_env.step))

    def run(state, action):
        with jax_boxbox_kernel():
            return step(state, action)

    return run


def _port_data(jd):
    return bridge.data_from_numpy(bridge.data_to_numpy(jd), "cpu")


# Nudged runs a comparison takes: on this world the drift of one nudged run
# varies by a factor of three from seed to seed (which of a cubelet's
# equally deep corners the contact budget keeps), so three runs, the
# other env tests' count, undersample it.
N_NUDGED = 8


def _nudges(qvel):
    """(n B, nv): `_torch_common.nudged_runs`' N_NUDGED nudged copies of
    qvel (B, nv), one after the other."""
    return torch.cat([qvel + NUDGE * torch.randn(qvel.shape, dtype=qvel.dtype,
                                                  generator=torch.Generator().manual_seed(s))
                      for s in range(N_NUDGED)])


def _split(arrays, B):
    """A `data_to_numpy` dict of the N_NUDGED runs' n B envs, as one dict
    of B envs a run."""
    return [{k: v[i * B:(i + 1) * B] for k, v in arrays.items()} for i in range(N_NUDGED)]


def _tile(arrays):
    return {k: np.concatenate([v] * N_NUDGED) for k, v in arrays.items()}


# ---------------------------------------------------------------------------
# index tables, face angles, distances, goals
# ---------------------------------------------------------------------------

def test_index_binding_matches_jax(port_env, jax_env):
    """Every qpos and dof address of the cube, the faces and the hand, and
    the face-up goal quats, equal; nq = 49, nv = 48; the 2 driver dofs
    damped, the 16 other cubelet hinges held by 16 joint equality rows."""
    for f in dataclasses.fields(t_cube.CubeIndex):
        np.testing.assert_array_equal(np.asarray(getattr(port_env.cube, f.name)),
                                      np.asarray(getattr(jax_env.cube, f.name)), err_msg=f.name)
    for f in dataclasses.fields(t_hand.HandIndex):
        np.testing.assert_array_equal(np.asarray(getattr(port_env.hand, f.name)),
                                      np.asarray(getattr(jax_env.hand, f.name)), err_msg=f.name)
    for name in ("driver_qpos", "top_face_qpos", "bottom_face_qpos", "goal_quat_for_face"):
        np.testing.assert_array_equal(getattr(port_env, name), getattr(jax_env, name),
                                      err_msg=name)
    assert t_face.TOP_FACE_JOINTS == j_face.TOP_FACE_JOINTS
    assert t_face.BOTTOM_FACE_JOINTS == j_face.BOTTOM_FACE_JOINTS
    assert (t_face._REMOVED_DRIVERS, t_face._REMOVED_ROTZ) == (j_face._REMOVED_DRIVERS,
                                                              j_face._REMOVED_ROTZ)
    c = port_env.model.const
    assert (c.nq, c.nv, c.neq) == (49, 48, 16)
    damped = np.flatnonzero(_np(port_env.model.dof_damping)[24:]) + 24
    drivers = [int(c.jnt_dofadr[c.names["joint"]["cube:" + j]])
               for j in (t_face.TOP_FACE_JOINTS[0], t_face.BOTTOM_FACE_JOINTS[0])]
    np.testing.assert_array_equal(damped, drivers)
    assert t_face.FacePerpendicularEnvConstants() == t_face.FacePerpendicularEnvConstants(
        **{f.name: getattr(j_face.FacePerpendicularEnvConstants(), f.name)
           for f in dataclasses.fields(t_face.FacePerpendicularEnvConstants)})


def _posed_states(jd, n_per):
    """Copies of the first env of the JAX batch `jd`, n_per of each of six
    poses (cube quat, face angles): z-aligned with pos_z up and the faces
    straight; upside down (neg_z up) with the faces near +pi/2 and near -pi;
    a face 0.5 rad off; the cube tilted 0.6 rad off z-aligned; faces just
    under +pi (rounding to -pi). Returns the JAX batch."""
    f = np.float32
    poses = [([0.0, 0.0, 0.3], [0.05, -0.03]), ([np.pi, 0.0, -1.2], [np.pi / 2 + 0.02, -3.1]),
             ([0.0, 0.0, 2.0], [0.5, 0.0]), ([0.6, 0.0, 0.4], [0.0, 0.02]),
             ([np.pi, 0.0, 0.1], [3.13, -0.1]), ([0.05, -0.04, -2.5], [3.1, 3.05])]
    n = len(poses) * n_per
    qpos = np.tile(np.asarray(jd.qpos[0], f), (n, 1))
    for i, (euler, faces) in enumerate(poses):
        rows = slice(i * n_per, (i + 1) * n_per)
        qpos[rows, 27:31] = _euler_quats([euler])[0]
        qpos[rows, 35] = faces[0]
        qpos[rows, 44] = faces[1]
    d = jax.tree_util.tree_map(lambda x: jnp.repeat(x[:1], n, axis=0), jd)
    return d.replace(qpos=jnp.asarray(qpos))


def test_face_angles_and_goal_distance_match_jax(port_env, jax_env, jax_reset):
    """`face_angles` and `_goal_distance` on the reset states and on posed
    states against seeded goals (quats and face angles beyond +-pi), 1e-6
    abs."""
    _, state, _ = jax_reset
    rng = np.random.default_rng(3)
    for jd in (state.physics, _posed_states(state.physics, 2)):
        d = _port_data(jd)
        n = d.qpos.shape[0]
        assert list(port_env.cube.cube_rot_qpos) == [27, 28, 29, 30]
        assert list(port_env.driver_qpos) == [35, 44]
        _close(port_env.face_angles(d), jax.vmap(jax_env.face_angles)(jd))
        goal = {"cube_quat": _unit_quats(rng, n),
                "cube_face_angle": rng.uniform(-5, 5, (n, 2)).astype(np.float32)}
        got = port_env._goal_distance({k: _t(v) for k, v in goal.items()}, d)
        want = jax.vmap(jax_env._goal_distance)({k: jnp.asarray(v) for k, v in goal.items()}, jd)
        for k in want:
            _close(got[k], want[k], msg=k)


def test_next_goal_matches_jax(port_env, jax_env, jax_reset):
    """`_next_goal` on posed states (`_posed_states`, 24 keys a pose) with
    the JAX keys' draws: goal quats and face angles 1e-6 abs, goal types
    exactly. The draws reach every branch: a rotation goal with each face
    up, turned cw and ccw; a flip goal to each face, from aligned states
    (a flip drawn) and unaligned ones."""
    _, state, _ = jax_reset
    n_per = 24
    jd = _posed_states(state.physics, n_per)
    keys = split(jax.random.PRNGKey(21), jd.qpos.shape[0])
    want = jax.vmap(jax_env._next_goal)(keys, jd)
    draws = _stack_draws([_goal_draws(k, k) for k in keys])
    got = port_env._next_goal(draws, _port_data(jd))
    _close(got["cube_quat"], want["cube_quat"], msg="cube_quat")
    _close(got["cube_face_angle"], want["cube_face_angle"], msg="cube_face_angle")
    np.testing.assert_array_equal(_np(got["goal_type"]), np.asarray(want["goal_type"]))
    assert _np(got["goal_type"]).dtype == np.int32
    rotate = _np(got["goal_type"]) == 1
    pose = np.arange(len(rotate)) // n_per
    face_up = np.where(pose == 1, 1, np.where(pose == 4, 1, 0))
    direction, face = _np(draws["direction"]), _np(draws["face"])
    seen = {(1, int(u), int(dr)) for u, dr in zip(face_up[rotate], direction[rotate])}
    aligned = ~np.isin(pose, (2, 3))
    seen |= {(0, int(fc), int(al)) for fc, al in zip(face[~rotate], aligned[~rotate])}
    want_seen = {(1, u, dr) for u in (0, 1) for dr in (0, 1)}
    want_seen |= {(0, fc, al) for fc in (0, 1) for al in (0, 1)}
    assert seen >= want_seen, want_seen - seen
    assert not rotate[~aligned].any()
    # a rotation goal turns only the face that is up, by a quarter
    g = _np(got["cube_face_angle"])
    rounded = _np(t_rot.round_to_straight_angles(port_env.face_angles(_port_data(jd))))
    turned = np.abs(_np(t_rot.normalize_angles(_t(g - rounded))))
    rows = np.flatnonzero(rotate)
    np.testing.assert_allclose(turned[rows, face_up[rows]], np.pi / 2, atol=1e-5)
    np.testing.assert_allclose(turned[rows, 1 - face_up[rows]], 0.0, atol=1e-6)


# ---------------------------------------------------------------------------
# construction, reset and step
# ---------------------------------------------------------------------------

def test_settle_matches_jax(port_env, jax_env):
    """The zero-control settle computed once at construction (200
    substeps), against the JAX env's `_settled_data`, by the nudge rule
    (runs of the same settle from start qvels nudged by 1e-6): the cube
    lands face down on the palm with about 46 live contacts against the
    budget of 32, and which of its cubelets' equally deep corners the
    budget keeps turns on float32 noise, so the cubelet hinges of nudged
    runs already part by about 1e-2 rad. The cube on the palm."""
    td = bridge.data_to_numpy(port_env._settled_data)
    jd = {k: v[None] for k, v in bridge.data_to_numpy(jax_env._settled_data).items()}
    cst, m = port_env.constants, port_env.model
    d0 = make_data(m, 1)
    d0 = d0.replace(ctrl=t_hand.denormalize_position_control(
        port_env.hand, m, d0, t_hand.zero_control(1, m.dtype, m.device), relative_action=False))

    d = t_core.data_map(lambda x: x.repeat((N_NUDGED,) + (1,) * (x.dim() - 1)), d0)
    nudged = t_step.step_n(m, d.replace(qvel=_nudges(d0.qvel)),
                           cst.reset_initial_steps * cst.mujoco_substeps)
    assert_physics_close(td, jd, port_env.cube, _split(bridge.data_to_numpy(nudged), 1),
                         whole=True)
    assert bool(_np(t_cube.is_on_palm(port_env.cube, port_env._settled_data)).all())


def _calm(td, jd, idx):
    """(B,) the envs within the env-step envelope of the reference in every
    group."""
    calm = np.ones(td["qpos"].shape[0], bool)
    for _, field, cols, tol in _groups(idx):
        calm &= _env_err(td, jd, field, cols) <= tol
    return calm


OBS_TOL = {"cube_pos": CUBE_POS_TOL, "qvel": QVEL_TOL, "fingertip_pos": 2e-3,
           "cube_quat": ANGLE_TOL, "goal_quat": 1e-6, "goal_face_angle": 1e-6, "goal_pos": 0.0}


def _compare_obs(tobs, jobs, calm):
    assert sorted(tobs) == sorted(jobs)
    for k in tobs:
        t, j = _np(tobs[k]), np.asarray(jobs[k])
        assert t.shape == j.shape and np.isfinite(t).all(), k
        _close(t[calm], j[calm], OBS_TOL.get(k, QPOS_TOL), msg=k)


def test_reset_matches_jax(port_env, jax_env, jax_reset):
    """`reset` on the draws of the JAX reset keys, from the JAX env's
    settled state (the settle itself parts the two packages' cubelet
    hinges, `test_settle_matches_jax`), against the JAX reset: the physics
    (the warmup's 100 substeps with a cubelet cube dropped at a random
    orientation onto the palm) by the nudge rule over the whole batch
    (`assert_physics_close`; runs from the settled state's qvel nudged by
    1e-6), the same envs on the palm (every env of this batch leaves the
    envelope: a tumbling cube of 26 cubelets under a contact budget);
    the goal of the reset's draws on the JAX reset's physics equal to the
    JAX goal (1e-6, types exactly), and the port's goal that of its own
    physics; on the envs within the envelope, if any, the obs within the
    envelope's tolerances; the tracker exactly."""
    keys, jstate, jobs = jax_reset
    attempts, draws = jax_reset_draws(keys, port_env.constants.max_pose_resets + 1)
    own = port_env._settled_data
    base = t_core.data_map(lambda x: x[None], _port_data(jax_env._settled_data))

    # the nudged runs in one batch: each run's B envs from its own nudged
    # settled state
    tiled = t_core.data_map(lambda x: x.expand((B,) + x.shape[1:]), base)
    tiled = bridge.data_from_numpy(_tile(bridge.data_to_numpy(tiled)), "cpu")
    try:
        port_env._settled_data = tiled.replace(qvel=_nudges(tiled.qvel[:B]))
        nudged = port_env.reset_physics(B * N_NUDGED, [{k: torch.cat([v] * N_NUDGED)
                                                        for k, v in a.items()}
                                                       for a in attempts])
        port_env._settled_data = base
        tstate, tobs = port_env.reset(B, attempts, draws)
    finally:
        port_env._settled_data = own
    td, jd = bridge.data_to_numpy(tstate.physics), bridge.data_to_numpy(jstate.physics)
    assert_physics_close(td, jd, port_env.cube, _split(bridge.data_to_numpy(nudged), B),
                         whole=True)
    np.testing.assert_array_equal(_np(t_cube.is_on_palm(port_env.cube, tstate.physics)),
                                  np.asarray(jax.vmap(lambda x: j_cube.is_on_palm(
                                      jax_env.cube, x))(jstate.physics)))
    # the goal: the reset's draws on the JAX reset's physics give the JAX
    # goal, and the port's reset state holds its own physics' goal
    on_jax = port_env._next_goal(draws, _port_data(jstate.physics))
    own_goal = port_env._next_goal(draws, tstate.physics)
    for k in ("cube_quat", "cube_face_angle", "goal_type"):
        _close(on_jax[k], jstate.goal[k], msg=k)
        assert torch.equal(tstate.goal[k], own_goal[k]), k
    for f in dataclasses.fields(t_core.TrackerState):
        np.testing.assert_array_equal(_np(getattr(tstate.tracker, f.name)),
                                      np.asarray(getattr(jstate.tracker, f.name)), err_msg=f.name)
    assert tstate.tracker.steps_by_type.shape == (B, 2)
    _compare_obs(tobs, jobs, _calm(td, jd, port_env.cube))


def _compare_step(tout, jout, idx, nudged=(), goal=True):
    """The port's step outputs against the JAX package's: physics within
    the env-step envelope, or by the nudge rule on the envs that the port's
    `nudged` step outputs show chaotic; on the other envs obs, rewards and
    distances within the envelope's tolerances (rewards: a quat distance
    and a face distance, 2 * ANGLE_TOL), and the goal (1e-6, types
    exactly); tracker, done and the info's integers and booleans exactly."""
    (ts, tobs, trew, tdone, tinfo), (js, jobs, jrew, jdone, jinfo) = tout, jout
    calm = ~assert_physics_close(bridge.data_to_numpy(ts.physics),
                                  bridge.data_to_numpy(js.physics), idx,
                                  nudged)
    if not goal:
        tobs = {k: v for k, v in tobs.items() if not k.startswith("goal_")}
        jobs = {k: v for k, v in jobs.items() if not k.startswith("goal_")}
    _compare_obs(tobs, jobs, calm)
    _close(_np(trew)[calm], np.asarray(jrew)[calm], 2 * ANGLE_TOL, "reward")
    np.testing.assert_array_equal(_np(tdone), np.asarray(jdone))
    assert sorted(tinfo) == sorted(jinfo)
    for k in tinfo:
        t, j = _np(tinfo[k]), np.asarray(jinfo[k])
        if t.dtype.kind == "f":
            tol = {"goal_dist_quat": ANGLE_TOL, "goal_dist_face": FACE_TOL}.get(k, 1e-6)
            _close(t[calm], j[calm], tol, msg=k)
        else:
            np.testing.assert_array_equal(t, j, err_msg=k)
    for f in dataclasses.fields(t_core.TrackerState):
        np.testing.assert_array_equal(_np(getattr(ts.tracker, f.name)),
                                      np.asarray(getattr(js.tracker, f.name)), err_msg=f.name)
    np.testing.assert_array_equal(_np(ts.t), np.asarray(js.t))
    if goal:
        for k in ("cube_quat", "cube_face_angle"):
            _close(_np(ts.goal[k])[calm], np.asarray(js.goal[k])[calm], msg=k)
        np.testing.assert_array_equal(_np(ts.goal["goal_type"]), np.asarray(js.goal["goal_type"]))
        for k, tol in (("cube_quat", ANGLE_TOL), ("cube_face_angle", FACE_TOL)):
            _close(_np(ts.prev_goal_distance[k])[calm],
                   np.asarray(js.prev_goal_distance[k])[calm], tol, msg=k)
    return calm


def _step_with_nudges(port_env, tstate, action, draws):
    """The port's step, and the physics (`data_to_numpy` dicts) of its
    N_NUDGED runs from qvels nudged by NUDGE, stepped as one batch."""
    tiled = bridge.env_state_from_numpy(_tile(bridge.env_state_to_numpy(tstate)), "cpu")
    tiled = tiled.replace(physics=tiled.physics.replace(qvel=_nudges(tstate.physics.qvel)))
    out = port_env.step(tiled, torch.cat([action] * N_NUDGED),
                        draws={k: torch.cat([v] * N_NUDGED) for k, v in draws.items()})
    return (port_env.step(tstate, action, draws=draws),
            _split(bridge.data_to_numpy(out[0].physics), tstate.t.shape[0]))


def test_step_matches_jax(port_env, jax_reset, jax_step):
    """Two env steps at B=4, each from the JAX state carried across by the
    bridge (the int32 goal type with it), with the same actions and the JAX
    keys' draws, held as `_compare_step` holds them."""
    _, jstate, jobs = jax_reset
    tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
    assert tstate.goal["goal_type"].dtype == torch.int32
    tobs = port_env._observe(tstate)
    for k in tobs:
        _close(tobs[k], jobs[k], msg=k)
    rng = np.random.default_rng(7)
    for _ in range(2):
        tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
        action = rng.uniform(-1, 1, (B, 20)).astype(np.float32)
        tout, nudged = _step_with_nudges(port_env, tstate, _t(action),
                                         jax_step_draws(jstate.key))
        jout = jax_step(jstate, jnp.asarray(action))
        _compare_step(tout, jout, port_env.cube, nudged)
        jstate = jout[0]


def test_step_goal_resample_matches_jax(port_env, jax_env, jax_reset, jax_step):
    """A state whose goal is each env's cube orientation and face angles
    after the step, with a hold of one step, so that every env reaches its
    goal and resamples it: with the JAX keys' draws every output matches as
    in `test_step_matches_jax`, the new goals among them; with the port's
    own draws every output but the new goal, and each new goal is a unit
    quat with w >= 0, its faces on multiples of pi/2, its type 0 or 1."""
    _, jstate, _ = jax_reset
    action = np.random.default_rng(8).uniform(-1, 1, (B, 20)).astype(np.float32)
    after = jax_step(jstate, jnp.asarray(action))[0]
    goal = dict(jstate.goal,
                cube_quat=jax.vmap(lambda d: j_cube.cube_quat(jax_env.cube, d))(after.physics),
                cube_face_angle=jax.vmap(jax_env.face_angles)(after.physics))
    jstate = jstate.replace(goal=goal)
    jout = jax_step(jstate, jnp.asarray(action))
    assert np.asarray(jout[4]["sub_goal_is_successful"]).all()
    assert (np.asarray(jout[0].tracker.goals_so_far) == 2).all()
    tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
    draws = jax_step_draws(jstate.key)
    tout, nudged = _step_with_nudges(port_env, tstate, _t(action), draws)
    _compare_step(tout, jout, port_env.cube, nudged)
    own = port_env.step(tstate, _t(action))
    _compare_step(own, jout, port_env.cube, nudged, goal=False)
    g = own[0].goal
    _close(t_rot.norm(g["cube_quat"]), np.ones(B))
    assert bool((g["cube_quat"][:, 0] >= 0).all())
    _close(g["cube_face_angle"], t_rot.round_to_straight_angles(g["cube_face_angle"]))
    assert set(_np(g["goal_type"]).tolist()) <= {0, 1}


# ---------------------------------------------------------------------------
# the face-damping transform and the wrapped face env
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _face_world_sizes():
    """`test_torch_wrappers`' draw table sized for the face world's bodies
    and tendons while inside."""
    arrays = snapshot_arrays(rubik_face_like.SNAPSHOT)
    old = tw.NBODY, tw.NTENDON
    tw.NBODY, tw.NTENDON = (int(arrays["const." + k]) for k in ("nbody", "ntendon"))
    try:
        yield
    finally:
        tw.NBODY, tw.NTENDON = old


def test_face_damping_matches_jax(port_env, jax_env):
    """`RandomizedFaceDampingWrapper` on the face env selects exactly the
    2 driver dofs, and its per-episode damping equals the JAX transform's
    on the JAX keys' draw (1e-6 relative); every other dof keeps its
    damping."""
    tj = JW.RandomizedFaceDampingWrapper(env=jax_env)
    tp = TW.RandomizedFaceDampingWrapper(env=port_env)
    c = port_env.model.const
    drivers = sorted(int(c.jnt_dofadr[c.names["joint"]["cube:" + j]])
                     for j in (t_face.TOP_FACE_JOINTS[0], t_face.BOTTOM_FACE_JOINTS[0]))
    np.testing.assert_array_equal(tp.dof_ids, drivers)
    np.testing.assert_array_equal(tp.dof_ids, tj.dof_ids)
    assert tuple(tp.model_fields) == tuple(tj.model_fields) == ("dof_damping",)
    keys = split(jax.random.PRNGKey(5), B)
    want = jax.vmap(lambda k: tj.model(None, jax_env.model, k).dof_damping)(keys)
    base = port_env.model.dof_damping
    got = tp.model(None, {"dof_damping": base.expand(B, -1).clone()},
                   tw.jax_draws(tj, "model", keys))["dof_damping"]
    tw.assert_tree_close(got, want, "dof_damping", atol=1e-12, rtol=1e-6)
    other = np.setdiff1d(np.arange(c.nv), drivers)
    assert torch.equal(got[:, other], base.expand(B, -1)[:, other])
    spread = _np(got[:, drivers].amax(0) - got[:, drivers].amin(0))
    assert (spread > 0).all()


@pytest.fixture(scope="module")
def wrapped(port_env, jax_env):
    """(JAX face env in the default stack plus the face-damping transform,
    the port's on the CPU)."""
    wl = JW.construct_default_dactyl_wrappers(randomize=True) + [["RandomizedFaceDampingWrapper"]]
    assert TW.construct_face_wrappers(randomize=True) == wl
    return JW.apply_named_wrappers(jax_env, wl), TW.apply_face_wrappers(port_env, randomize=True)


# the fields the stack overrides that the face world leaves equal across
# envs, and why (chip_smoke.FACE_WRAPPED_SAME)
FACE_SAME = {"body_pos", "geom_size", "tendon_range"}


@pytest.fixture(scope="module")
def jax_wrapped_reset(wrapped, jax_reset_fn):
    """The JAX wrapped reset at B from seeded keys, and its inner env's
    reset (each key's first split): (keys, state, obs, inner state, inner
    obs). The inner reset runs once, through the module's compiled reset;
    the wrapped reset takes it from there by its key, so that it is not
    compiled a second time."""
    jw, _ = wrapped
    keys = split(jax.random.PRNGKey(13), B)
    inner_keys = jnp.stack([split(k, 4)[0] for k in keys])
    inner, inner_obs = jax_reset_fn(inner_keys)
    env = jw.env

    class Inner:
        """The JAX env, its reset looked up from the inner reset."""

        def __getattr__(self, name):
            return getattr(env, name)

        def reset(self, key):
            i = jnp.argmax(jnp.all(inner_keys == key, axis=-1))
            return jax.tree_util.tree_map(lambda x: x[i], (inner, inner_obs))

    jw.env = Inner()
    try:
        with jax_boxbox_kernel():
            state, obs = jax.jit(jax.vmap(jw.reset))(keys)
    finally:
        jw.env = env
    return keys, state, obs, inner, inner_obs


def test_wrapped_face_reset_matches_jax(wrapped, jax_wrapped_reset):
    """`wrap_reset` on the JAX env's own reset state with the JAX draws:
    observations and transform states to 1e-6 abs, the 12 model fields to
    1e-6 relative. The face world leaves three of them equal across envs
    in both packages (`FACE_SAME`: no cube:middle, cube:top or cube:bottom
    geom or body for the cube-size scale, no tendon range to widen) and
    the timestep the compiled one until the first step; `dof_damping`
    differs across envs on the 2 driver dofs."""
    jw, pw = wrapped
    keys, jstate, jobs, inner, inner_obs = jax_wrapped_reset
    n = len(jw.transforms)
    assert n == 31 and isinstance(pw.transforms[-1], TW.RandomizedFaceDampingWrapper)
    k4 = tw._key_splits(keys, 4)
    ki, km, ko = (tw._key_splits(k4[:, j], n) for j in (1, 2, 3))
    with _face_world_sizes():
        obs_fn = tw._hook_draws(jw, "observation", ko)

        def observation_draws(i, tstate, obs):
            if isinstance(jw.transforms[i], tw.j_rand.RandomizeObservationWrapper):
                tstate = {"key": ki[:, i]}
            return obs_fn(i, tstate, obs)

        draws = {"init": tw._hook_draws(jw, "init", ki), "model": tw._hook_draws(jw, "model", km),
                 "observation": observation_draws}
        pstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(inner), "cpu")
        pobs = {k: torch.as_tensor(np.array(v)) for k, v in inner_obs.items()}
        got_state, got_obs = pw.wrap_reset(pstate, pobs, draws)
    assert sorted(got_obs) == sorted(jobs)
    tw.assert_tree_close(got_obs, dict(jobs), "obs")
    tw.assert_tree_close(got_state.goal_aux[1], jstate.goal_aux[1], "tstates")
    assert sorted(got_state.model_fields) == sorted(jstate.model_fields)
    assert len(got_state.model_fields) == 12
    tw.assert_tree_close(got_state.model_fields, jstate.model_fields, "model_fields",
                         atol=1e-12, rtol=1e-6)
    for k, v in got_state.model_fields.items():
        same = bool((v == v[:1]).all())
        assert same == (k in FACE_SAME | {"opt:timestep"}), k
        if same:
            assert torch.equal(v[0], model_field(pw.env.model, k)), k
    damp = got_state.model_fields["dof_damping"]
    drivers = torch.as_tensor(pw.transforms[-1].dof_ids)
    assert bool((damp[:, drivers].amax(0) > damp[:, drivers].amin(0)).all())


def test_wrapped_face_steps_match_jax(wrapped, jax_wrapped_reset):
    """Two steps of the whole stack, each from the JAX state carried across
    by the bridge, with the same discrete actions and the JAX draws: the
    timestep field (1e-6 relative), dones and the transform states'
    integers and booleans exactly, the physics by the nudge rule, and on
    the other envs observations, rewards and the transform states' floats
    within the envelope's tolerances (test_torch_wrappers.py's)."""
    jw, pw = wrapped
    _, jstate, _, _, _ = jax_wrapped_reset
    jstep = jax.jit(jax.vmap(jw.step))
    rng = np.random.default_rng(5)
    n = len(jw.transforms)
    for step in range(2):
        pstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
        action = rng.integers(0, 11, (B, 20)).astype(np.int32)
        key, k_act, k_obs = (tw._key_splits(np.asarray(jstate.key), 3)[:, j] for j in range(3))
        with _face_world_sizes():
            draws = {
                "action": tw._hook_draws(jw, "action", tw._key_splits(k_act, n)),
                "model_step": tw._hook_draws(jw, "model_step", tw._key_splits(
                    jnp.stack([jax.random.fold_in(k, 1) for k in key]), n)),
                "physics": tw._hook_draws(jw, "physics", tw._key_splits(
                    jnp.stack([jax.random.fold_in(k, 2) for k in key]), n)),
                "observation": tw._hook_draws(jw, "observation", tw._key_splits(k_obs, n)),
                "env": jax_step_draws(key),
            }
            with jax_boxbox_kernel():
                jout = jstep(jstate, jnp.asarray(action))

            def run(qvel):
                st = pstate.replace(physics=pstate.physics.replace(qvel=qvel))
                return pw.step(st, torch.as_tensor(action), draws)

            tout = pw.step(pstate, torch.as_tensor(action), draws)
            nudged = nudged_runs(run, pstate.physics.qvel, N_NUDGED)
        calm = ~assert_physics_close(bridge.data_to_numpy(tout[0].physics),
                                     bridge.data_to_numpy(jout[0].physics), pw.env.cube,
                                     [bridge.data_to_numpy(x[0].physics) for x in nudged])
        np.testing.assert_allclose(_np(tout[0].model_fields["opt:timestep"]),
                                   np.asarray(jout[0].model_fields["opt:timestep"]), rtol=1e-6)
        np.testing.assert_array_equal(_np(tout[3]), np.asarray(jout[3]))
        assert sorted(tout[1]) == sorted(jout[1])
        for k in tout[1]:
            np.testing.assert_allclose(_np(tout[1][k])[calm], np.asarray(jout[1][k])[calm],
                                       rtol=0, atol=tw.obs_tol(k), err_msg=f"{k} at step {step}")
        np.testing.assert_allclose(_np(tout[2])[calm], np.asarray(jout[2])[calm], rtol=0,
                                   atol=2 * ANGLE_TOL)
        tw._calm_tree_close(tout[0].goal_aux[1], jout[0].goal_aux[1], calm, f"tstates {step}")
        jstate = jout[0]
