"""The port's full-perpendicular Rubik's env against the JAX package's, on the
CPU at B=4: the rotation additions, the cube manipulator (face turns,
snapping, soft alignment, the scramble), the stand-in world's hinge order,
the solver bridge, the env's index tables, goal distance and goal
generators (the three sampling modes and the solver goals), the solver
hop, its construction's settle, `reset` and `step`, the perpendicular
cube-size transform, and the full stack (the face stack and that
transform) around the env.

The JAX env is built on the stand-in world
(`robogym_torch/worlds/rubik_full_like.py`, nv = 96) by pointing
`full_perpendicular.build_full_world_xml`, in this process only, at the
world's XML, at float32, its box-box pairs through its Pallas kernel in
interpret mode (`jax_boxbox_kernel`). Random draws are made from the JAX
keys (the same splits as the JAX functions make) and fed to the port's
apply functions; the JAX goal's face to turn and face to put up come from
one randint on one key, so the port's one `face` draw is that randint.
States cross by `bridge.env_state_to_numpy` / `env_state_from_numpy`. The
JAX solver module is given the port's loaded solver library (one source,
`native/rubik/two_phase.cc`), so that its loader does not rebuild the
library into `native/`.

Tolerances: the rotation functions, face angles, distances and goals on
the same states 1e-6 abs (goal types, axes and branch booleans exactly);
after a face turn or a scramble, cubelet matrices 1e-5 abs (near
e1 = +-pi/2 the two packages' float32 `mat2euler` may pick different
euler triples for one matrix, so triples are compared as the rotations
they give), driver angles 1e-6 abs (1e-6 relative beyond 1 rad: 50
quarter turns take a driver to tens of radians), rounded permutations,
facelet strings, solutions and plans exactly; a cubelet geom's centre 1e-5
m from where its matrix puts it; the physics of the settle, the reset and
each step by the env-step envelope of `_torch_common.assert_physics_close`
(cube position 2e-4 m, qpos 1e-3, qvel 5e-2) and its nudge rule with 8
nudged runs; on the envs within the envelope, obs, rewards and distances
within the tolerances the envelope gives them (a quat distance 4e-3, as
tests/test_torch_env.py derives it; a face distance, the norm of six
wrapped angles each within 1e-3, 3e-3); tracker fields, done and the
info's integers and booleans exactly; the wrapped env as
tests/test_torch_wrappers.py holds the locked one's."""

import contextlib
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_face as tf
import test_torch_wrappers as tw
from _torch_common import (NUDGE_RATIO, QPOS_TOL, _env_err, _groups, assert_physics_close,
                           jax_boxbox_kernel, jax_data_from_numpy, nudged_runs, snapshot_arrays,
                           snapshot_jax_model, snapshot_model)
from robogym_torch import bridge
from robogym_torch import wrappers as TW
from robogym_torch.envs import core as t_core
from robogym_torch.envs.dactyl import cube_env as t_cube
from robogym_torch.envs.dactyl import cube_manipulator as t_manip
from robogym_torch.envs.dactyl import full_perpendicular as t_full
from robogym_torch.envs.dactyl import goals_solver as t_gs
from robogym_torch.mjcf.model import make_data
from robogym_torch.physics import step as t_step
from robogym_torch.robot import shadow_hand as t_hand
from robogym_torch.utils import rotation as t_rot
from robogym_torch.utils import rubik_utils as t_ru
from robogym_torch.worlds import rubik_face_like, rubik_full_like
from robogym_torch.wrappers.core import model_field
from robogym_tpu import wrappers as JW
from robogym_tpu.envs.dactyl import cube_env as j_cube
from robogym_tpu.envs.dactyl import cube_manipulator as j_manip
from robogym_tpu.envs.dactyl import full_perpendicular as j_full
from robogym_tpu.envs.dactyl import goals_solver as j_gs
from robogym_tpu.utils import rotation as j_rot
from robogym_tpu.utils import rubik_utils as j_ru
from robogym_tpu.wrappers import parametric as j_param

B = 4
split = jax.random.split
f32 = np.float32
ANGLE_TOL = tf.ANGLE_TOL
# a face-angle distance: the norm of six wrapped angles, each within QPOS_TOL
FACE_TOL = 3 * QPOS_TOL
N_NUDGED = tf.N_NUDGED
SCRAMBLE_STEPS = t_full.FullPerpendicularEnvConstants().num_scramble_steps

_np, _t, _close = tf._np, tf._t, tf._close
# the stand-in world's face driver qpos addresses, DRIVER_NAMES order
DRIVER_QPOS = np.asarray(t_manip.CubeletIndex.build(
    snapshot_model(rubik_full_like.SNAPSHOT)).driver_qpos)


def _tile(arrays):
    """`tf._tile` of a `data_to_numpy` or `env_state_to_numpy` dict: N_NUDGED
    copies of every batched array (a tree's spec, 0-d, stays as it is)."""
    return {k: v if np.ndim(v) == 0 else np.concatenate([v] * N_NUDGED)
            for k, v in arrays.items()}


def _mats(eulers):
    return np.asarray(jax.vmap(j_rot.euler2mat)(jnp.asarray(np.asarray(eulers, f32))))


def _assert_same_cube(got_qpos, want_qpos, idx, msg=""):
    """Two qpos batches hold the same cube: cubelet matrices 1e-5, the
    rounded permutations exactly, driver angles 1e-6 (relative beyond 1
    rad)."""
    got, want = _np(got_qpos), np.asarray(want_qpos)
    eq = np.asarray(idx.euler_qpos)
    mg, mw = _mats(got[:, eq]), _mats(want[:, eq])
    _close(mg, mw, 1e-5, msg=f"{msg} matrices")
    np.testing.assert_array_equal(np.round(mg), np.round(mw), err_msg=f"{msg} permutations")
    dq = np.asarray(idx.driver_qpos)
    np.testing.assert_allclose(got[:, dq], want[:, dq], rtol=1e-6, atol=1e-6,
                               err_msg=f"{msg} drivers")


@pytest.fixture(scope="module", autouse=True)
def shared_solver_library():
    """The JAX solver module on the port's loaded library."""
    old = j_ru._lib
    j_ru._lib = t_ru.get_library()
    yield
    j_ru._lib = old


# ---------------------------------------------------------------------------
# rotation additions
# ---------------------------------------------------------------------------

def _signed_permutations():
    """(24, 3, 3) the proper signed permutation matrices."""
    out = []
    for perm in ((0, 1, 2), (0, 2, 1), (1, 0, 2), (1, 2, 0), (2, 0, 1), (2, 1, 0)):
        for signs in np.ndindex(2, 2, 2):
            m = np.zeros((3, 3), f32)
            for r, c in enumerate(perm):
                m[r, c] = 1.0 - 2.0 * signs[r]
            if np.linalg.det(m) > 0:
                out.append(m)
    return np.stack(out)


def test_rotation_additions_match_jax():
    """euler2mat on seeded triples, on gimbal-lock triples (e1 = +-pi/2) and
    on multiples of pi/2; mat2euler on their matrices and on the 24 signed
    permutations (its cy <= eps branch at the permutations with e1 =
    +-pi/2), as triples away from the lock and as the rotations they give
    everywhere; rot_xyz_aligned on seeded quats and on quats near each of
    the 24 cube rotations, both answers reached: 1e-6 abs, booleans
    exactly."""
    rng = np.random.default_rng(0)
    lock = np.stack([rng.uniform(-3, 3, 16), np.tile([np.pi / 2, -np.pi / 2], 8),
                     rng.uniform(-3, 3, 16)], 1)
    straight = np.stack(np.meshgrid(*[np.arange(-2, 3) * np.pi / 2] * 3), -1).reshape(-1, 3)
    eul = np.concatenate([rng.uniform(-4, 4, (64, 3)), lock, straight]).astype(f32)
    _close(t_rot.euler2mat(_t(eul)), _mats(eul))

    perms = _signed_permutations()
    mats = np.concatenate([_mats(eul), perms]).astype(f32)
    got = _np(t_rot.mat2euler(_t(mats)))
    want = np.asarray(jax.vmap(j_rot.mat2euler)(jnp.asarray(mats)))
    cy = np.sqrt(mats[:, 2, 2] ** 2 + mats[:, 1, 2] ** 2)
    free = cy > 1e-3
    _close(got[free], want[free])
    _close(_mats(got), _mats(want))
    _close(_mats(got[-24:]), perms)
    assert (cy[-24:] <= 4 * np.finfo(np.float64).eps).sum() == 8   # the lock branch

    near = np.asarray(t_cube.PARALLEL_QUATS, f32)
    tilt = tf._euler_quats(rng.normal(0, 0.25, (24, 3)))
    quats = np.concatenate([tf._unit_quats(rng, 64), near,
                            np.asarray(j_rot.quat_mul(jnp.asarray(near), jnp.asarray(tilt)))])
    quats = quats.astype(f32)
    got = _np(t_rot.rot_xyz_aligned(_t(quats), 0.4))
    np.testing.assert_array_equal(got, np.asarray(j_rot.rot_xyz_aligned(quats, 0.4)))
    assert got[64:88].all() and not got.all()


# ---------------------------------------------------------------------------
# the cube manipulator on the stand-in world's tables
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cubelets():
    """(the port's CubeletIndex, the JAX package's) of the stand-in world."""
    idx = t_manip.CubeletIndex.build(snapshot_model(rubik_full_like.SNAPSHOT))
    jidx = j_manip.CubeletIndex.build(snapshot_jax_model(rubik_full_like.SNAPSHOT))
    return idx, jidx


def _solved_qpos(n):
    qpos = np.zeros((n, 97), f32)
    qpos[:, 27] = 1.0
    return qpos


def _scramble_draws(k_scramble, n_steps):
    """The port's scramble draws of one env from the JAX scramble key."""
    per = []
    for k in split(k_scramble, n_steps):
        k1, k2, k3 = split(k, 3)
        per.append((int(jax.random.randint(k1, (), 0, 3)), int(jax.random.randint(k2, (), 0, 2)),
                    bool(jax.random.bernoulli(k3))))
    axis, side, sign = (np.asarray(x) for x in zip(*per))
    return dict(axis=axis, side=side, sign=sign)


def _stack(ds):
    return {k: _t(np.stack([d[k] for d in ds])) for k in ds[0]}


def _jax_scrambled(jidx, keys, n_steps=SCRAMBLE_STEPS, qpos=None):
    qpos = _solved_qpos(len(keys)) if qpos is None else qpos
    return np.asarray(jax.jit(jax.vmap(lambda q, k: j_manip.scramble(jidx, q, k, n_steps)))(
        jnp.asarray(qpos), keys))


def test_cubelet_index_matches_jax(cubelets):
    """The port's CubeletIndex equals the JAX package's on the stand-in
    world; its names and driver coordinates are the JAX package's."""
    idx, jidx = cubelets
    for f in dataclasses.fields(t_manip.CubeletIndex):
        np.testing.assert_array_equal(np.asarray(getattr(idx, f.name)),
                                      np.asarray(getattr(jidx, f.name)), err_msg=f.name)
    assert t_manip.DRIVER_NAMES == j_manip.DRIVER_NAMES
    np.testing.assert_array_equal(t_manip.DRIVER_COORDS, j_manip.DRIVER_COORDS)
    assert [n for n, _ in t_manip._cubelet_names()] == [n for n, _ in j_manip._cubelet_names()]


def test_scramble_matches_jax(cubelets):
    """`scramble` (50 quarter turns, then a snap) on the JAX keys' draws,
    from the solved cube: the same cube; every cubelet matrix a signed
    permutation and the 20 cubelets on 20 distinct cells."""
    idx, jidx = cubelets
    keys = split(jax.random.PRNGKey(3), 8)
    want = _jax_scrambled(jidx, keys)
    draws = _stack([_scramble_draws(k, SCRAMBLE_STEPS) for k in keys])
    got = t_manip.scramble(idx, _t(_solved_qpos(8)), draws)
    _assert_same_cube(got, want, idx, "scramble")
    mats = _np(t_rot.euler2mat(t_manip.cubelet_eulers(idx, got)))
    _close(np.abs(mats).sum(-1), np.ones((8, 20, 3)), 1e-5)
    cells = np.rint(np.einsum("bcij,cj->bci", mats, idx.coords)).astype(int)
    assert all(len({tuple(c) for c in env}) == 20 for env in cells)


def test_rotate_face_and_snap_match_jax(cubelets):
    """`rotate_face` with per-env axis, side and angle (quarter turns and
    seeded angles beyond +-pi) on scrambled cubes, and `snap_cubelets` of
    the result, against the JAX functions on each env; four quarter turns
    of a face give the cube back and its driver 2 pi; a turn of the solved
    cube moves exactly the nine pieces of that face (its 8 cubelets and its
    driver)."""
    idx, jidx = cubelets
    rng = np.random.default_rng(1)
    n = 24
    qpos = _jax_scrambled(jidx, split(jax.random.PRNGKey(4), n))
    axis = np.arange(n) % 3
    side = (np.arange(n) // 3) % 2
    angle = np.where(np.arange(n) < 12, np.tile([np.pi / 2, -np.pi / 2], 12)[:n],
                     rng.uniform(-5, 5, n)).astype(f32)
    jrot = jax.vmap(lambda q, a, s, g: j_manip.rotate_face(jidx, q, a, s, g))
    want = np.asarray(jrot(jnp.asarray(qpos), jnp.asarray(axis), jnp.asarray(side),
                           jnp.asarray(angle)))
    got = t_manip.rotate_face(idx, _t(qpos), _t(axis), _t(side), _t(angle))
    _assert_same_cube(got, want, idx, "rotate_face")
    snapped = jax.vmap(lambda q: j_manip.snap_cubelets(jidx, q))(jnp.asarray(want))
    _assert_same_cube(t_manip.snap_cubelets(idx, got), snapped, idx, "snap")

    # four quarter turns of each face
    q0 = _t(_solved_qpos(6))
    faces = torch.arange(6)
    q = q0
    for _ in range(4):
        q = t_manip.rotate_face(idx, q, faces // 2, faces % 2,
                                torch.full((6,), np.pi / 2, dtype=torch.float32))
    mats4 = _np(t_rot.euler2mat(t_manip.cubelet_eulers(idx, t_manip.snap_cubelets(idx, q))))
    _close(mats4, np.broadcast_to(np.eye(3), mats4.shape), 1e-5)
    _close(t_manip.driver_angles(idx, q), 2 * np.pi * np.eye(6), 1e-5)
    # nine pieces: the 8 cubelets at the face's home cells, and its driver
    q1 = t_manip.rotate_face(idx, q0, faces // 2, faces % 2,
                             torch.full((6,), np.pi / 2, dtype=torch.float32))
    moved = _np((t_manip.cubelet_eulers(idx, q1) != t_manip.cubelet_eulers(idx, q0)).any(-1))
    for f in range(6):
        home = idx.coords[:, f // 2] == (1 if f % 2 else -1)
        np.testing.assert_array_equal(moved[f], home)
        assert home.sum() == 8
    turned = _np(t_manip.driver_angles(idx, q1) != t_manip.driver_angles(idx, q0))
    np.testing.assert_array_equal(turned, np.eye(6, dtype=bool))


def test_soft_align_faces_matches_jax(cubelets):
    """`soft_align_faces` on scrambled cubes with each face turned off
    straight by a seeded angle in +-0.3 rad (its cubelets with it), and on
    the same with the drivers alone moved: the JAX package's cube, every
    face angle then on a multiple of pi/2."""
    idx, jidx = cubelets
    rng = np.random.default_rng(2)
    n = 12
    qpos = _jax_scrambled(jidx, split(jax.random.PRNGKey(5), n))
    off = rng.uniform(-0.3, 0.3, (n, 6)).astype(f32)
    q = _t(qpos)
    for f in range(6):
        full = torch.full((n,), f)
        q = t_manip.rotate_face(idx, q, full // 2, full % 2, _t(off[:, f]))
    moved = qpos.copy()
    moved[:, np.asarray(idx.driver_qpos)] += off
    jalign = jax.jit(jax.vmap(lambda x: j_manip.soft_align_faces(jidx, x)))
    for start in (_np(q), moved):
        got = t_manip.soft_align_faces(idx, _t(start))
        _assert_same_cube(got, jalign(jnp.asarray(start)), idx, "soft_align")
        a = t_manip.driver_angles(idx, got)
        _close(t_rot.normalize_angles(a - t_rot.round_to_straight_angles(a) + 1.0) - 1.0,
               np.zeros((n, 6)), 1e-5)


def test_hinge_order_places_cubelets(cubelets):
    """After scrambles and a face turn of 0.3 rad and `fwd_position`, each
    cubelet geom's centre sits at R coords SPACING in the cube's frame and
    its box turned by R (R = euler2mat of its hinge angles), each face
    centre at its home cell: the world lists each cubelet's hinges in the
    order rotx, roty, rotz, which MuJoCo composes as euler2mat. 1e-5."""
    idx, jidx = cubelets
    m = snapshot_model(rubik_full_like.SNAPSHOT)
    n = 6
    qpos = _jax_scrambled(jidx, split(jax.random.PRNGKey(6), n), qpos=np.tile(
        _np(m.qpos0), (n, 1)))
    faces = torch.arange(n)
    q = t_manip.rotate_face(idx, _t(qpos), faces // 2, faces % 2,
                            torch.full((n,), 0.3, dtype=torch.float32))
    d = t_step.fwd_position(m, make_data(m, n, q))
    c = m.const
    cube = c.names["body"]["cube:middle"]
    R_cube = d.xmat[:, cube]
    geoms = [c.names["geom"][f"cube:cubelet:{name}"] for name, _ in t_manip._cubelet_names()]
    local = torch.einsum("bji,bgj->bgi", R_cube, d.geom_xpos[:, geoms] - d.xpos[:, cube, None])
    R = t_rot.euler2mat(t_manip.cubelet_eulers(idx, q))
    coords = torch.as_tensor(idx.coords, dtype=torch.float32)
    want = torch.einsum("bcij,cj->bci", R, coords) * rubik_face_like.SPACING
    _close(local, want, 1e-5)
    box = torch.einsum("bji,bgjk->bgik", R_cube, d.geom_xmat[:, geoms])
    _close(box, R, 1e-5)
    centres = [c.names["geom"]["cube:cubelet:" + nm.rsplit(":", 1)[1]]
               for nm in t_manip.DRIVER_NAMES]
    local_c = torch.einsum("bji,bgj->bgi", R_cube, d.geom_xpos[:, centres] - d.xpos[:, cube, None])
    _close(local_c, np.broadcast_to(t_manip.DRIVER_COORDS * rubik_face_like.SPACING,
                                    local_c.shape), 1e-5)


# ---------------------------------------------------------------------------
# the solver bridge
# ---------------------------------------------------------------------------

def test_rubik_utils_match_jax(cubelets):
    """The port's copy of `rubik_utils` against the JAX package's: the
    tables; facelet strings of scrambled cubes, their solutions, the
    solutions as face rotations, `apply_moves` of them (each string or
    list equal); the solution applied by `rotate_face` to the cube gives
    the solved facelets; illegal strings give None; `legal_cubes` tells a
    scrambled cube from one with a cubelet twisted off its cell."""
    idx, jidx = cubelets
    assert t_ru.SOLVED_FACELETS == j_ru.SOLVED_FACELETS
    assert t_ru.MOVE_FACE == j_ru.MOVE_FACE
    for (tc, tn), (jc, jn) in zip(t_ru._facelet_table(), j_ru._facelet_table()):
        np.testing.assert_array_equal(tc, jc)
        np.testing.assert_array_equal(tn, jn)
    n = 8
    qpos = _jax_scrambled(jidx, split(jax.random.PRNGKey(7), n))
    mats = np.round(_mats(qpos[:, np.asarray(idx.euler_qpos)]))
    for i in range(n):
        facelets = t_ru.cubelets_to_facelets(idx.coords, mats[i])
        assert facelets == j_ru.cubelets_to_facelets(jidx.coords, mats[i])
        sol = t_ru.solve_fast(facelets)
        assert sol is not None and sol == j_ru.solve_fast(facelets)
        assert t_ru.apply_moves(facelets, sol) == t_ru.SOLVED_FACELETS
        assert t_ru.apply_moves(facelets, sol) == j_ru.apply_moves(facelets, sol)
        steps = t_ru.moves_to_face_rotations(sol)
        assert steps == j_ru.moves_to_face_rotations(sol)
        q = _t(qpos[i:i + 1])
        for axis, side, angle in steps:
            q = t_manip.rotate_face(idx, q, torch.tensor([axis]), torch.tensor([side]),
                                    torch.tensor([angle], dtype=torch.float32))
        solved = t_gs.snapped_matrices(idx, q)[0]
        assert t_ru.cubelets_to_facelets(idx.coords, solved) == t_ru.SOLVED_FACELETS
    bad = t_ru.SOLVED_FACELETS[:4] + "R" + t_ru.SOLVED_FACELETS[5:]
    assert t_ru.solve_fast(bad) is None and j_ru.solve_fast(bad) is None
    assert t_ru.is_legal(t_ru.SOLVED_FACELETS) and not t_ru.is_legal(bad)
    # `legal_cubes`: every scrambled cube; not one whose cubelet is turned
    # 0.7 rad (past the 30 degrees that rounding recovers)
    twisted = qpos.copy()
    twisted[1, int(idx.euler_qpos[3, 0])] += 0.7
    np.testing.assert_array_equal(t_gs.legal_cubes(idx, _t(twisted)),
                                  [True, False] + [True] * (n - 2))


# ---------------------------------------------------------------------------
# the env: the port's on the CPU, the JAX one on the stand-in world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_env():
    return t_full.make_env(device="cpu", seed=0)


@pytest.fixture(scope="module")
def jax_env(tmp_path_factory):
    """The JAX FullPerpendicularEnv on the stand-in world:
    `build_full_world_xml` returns the world's XML while the env is built."""
    xml = rubik_full_like.write(str(tmp_path_factory.mktemp("rubik")))
    orig = j_full.build_full_world_xml
    j_full.build_full_world_xml = lambda: xml
    try:
        with jax_boxbox_kernel():
            return j_full.FullPerpendicularEnv(j_full.FullPerpendicularEnvConstants(),
                                               dtype=jnp.float32)
    finally:
        j_full.build_full_world_xml = orig


def _with_mode(env, mode, package):
    """A copy of `env` (either package's) with another goal_generation."""
    out = copy.copy(env)
    out.constants = dataclasses.replace(env.constants, goal_generation=mode)
    if package == "port":
        out.generator = torch.Generator().manual_seed(0)
    return out


def _goal_draws(k_goal, k_pause):
    """The port's `draw_step` draws from the JAX goal and hold keys:
    `face` is the randint on `k_face` that the JAX goal takes twice."""
    k_flip, k_dir, k_z, k_face, k_ang = split(k_goal, 5)
    return dict(flip_u=f32(jax.random.uniform(k_flip, (), jnp.float32)),
                direction=np.int64(jax.random.randint(k_dir, (), 0, 2)),
                z_u=f32(jax.random.uniform(k_z, (), jnp.float32)),
                face=np.int64(jax.random.randint(k_face, (), 0, 6)),
                angle_u=f32(jax.random.uniform(k_ang, (), jnp.float32)),
                pause_u=f32(jax.random.uniform(k_pause, ())))


def jax_reset_draws(keys, n_attempts):
    """The port's `reset` draws from the JAX reset keys: (start, attempts,
    draws)."""
    starts, per_env = [], []
    for key in keys:
        k_phys, k_goal, k_pause, _ = split(key, 4)
        k_scramble, k_faceang, k_pose = split(k_phys, 3)
        starts.append(dict(_scramble_draws(k_scramble, SCRAMBLE_STEPS),
                           face_u=np.asarray(jax.random.uniform(k_faceang, (6,), jnp.float32))))
        k, k0 = split(k_pose)
        att = [tf._attempt_draws(k0)]
        for _ in range(n_attempts - 1):
            k, ki = split(k)
            att.append(tf._attempt_draws(ki))
        per_env.append((att, _goal_draws(k_goal, k_pause)))
    attempts = [dict(wiggle=_t(np.stack([e[0][i][0] for e in per_env])),
                     quat=_t(np.stack([e[0][i][1] for e in per_env])),
                     action=_t(np.stack([e[0][i][2] for e in per_env])))
                for i in range(n_attempts)]
    return _stack(starts), attempts, _stack([e[1] for e in per_env])


def jax_step_draws(keys):
    """The port's `step` draws from the JAX step keys (B, 2)."""
    out = []
    for key in np.asarray(keys):
        _, k_goal, k_pause = split(jnp.asarray(key), 3)
        out.append(_goal_draws(k_goal, k_pause))
    return _stack(out)


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


def test_index_binding_matches_jax(port_env, jax_env):
    """Every qpos and dof address of the cube, the cubelets and the hand,
    the face-up goal quats and the fixed scramble's plan equal; nq = 97,
    nv = 96; the 66 piece dofs with friction loss, the 6 driver dofs
    damped; the constants the JAX package's."""
    for f in dataclasses.fields(t_cube.CubeIndex):
        np.testing.assert_array_equal(np.asarray(getattr(port_env.cube, f.name)),
                                      np.asarray(getattr(jax_env.cube, f.name)), err_msg=f.name)
    for f in dataclasses.fields(t_hand.HandIndex):
        np.testing.assert_array_equal(np.asarray(getattr(port_env.hand, f.name)),
                                      np.asarray(getattr(jax_env.hand, f.name)), err_msg=f.name)
    for f in dataclasses.fields(t_manip.CubeletIndex):
        np.testing.assert_array_equal(np.asarray(getattr(port_env.cubelets, f.name)),
                                      np.asarray(getattr(jax_env.cubelets, f.name)))
    np.testing.assert_array_equal(port_env.goal_quat_for_face, jax_env.goal_quat_for_face)
    plan, length = port_env.fixed_scramble_plan(2)
    jplan, jlength = jax_env._fixed_scramble_plan()
    np.testing.assert_array_equal(_np(plan), np.broadcast_to(np.asarray(jplan), plan.shape))
    np.testing.assert_array_equal(_np(length), [int(jlength)] * 2)
    assert t_full.FIXED_FAIR_SCRAMBLE == jax_env.FIXED_FAIR_SCRAMBLE
    c = port_env.model.const
    assert (c.nq, c.nv, c.neq) == (97, 96, 0)
    fl = np.flatnonzero(_np(port_env.model.dof_frictionloss))
    np.testing.assert_array_equal(fl, np.arange(30, 96))
    drivers = [int(c.jnt_dofadr[c.names["joint"]["cube:" + j]]) for j in t_manip.DRIVER_NAMES]
    np.testing.assert_array_equal(np.flatnonzero(_np(port_env.model.dof_damping)[24:]) + 24,
                                  sorted(drivers))
    assert t_full.FullPerpendicularEnvConstants() == t_full.FullPerpendicularEnvConstants(
        **{f.name: getattr(j_full.FullPerpendicularEnvConstants(), f.name)
           for f in dataclasses.fields(t_full.FullPerpendicularEnvConstants)})


def _posed_states(jd, n_per):
    """Copies of the first env of the JAX batch `jd`, n_per of each of six
    poses (cube euler angles, face-angle offsets from the current faces):
    straight with pos_z up; upside down with the faces near +pi/2 and -pi;
    a face 0.5 rad off; the cube tilted 0.6 rad; faces just under +pi;
    the cube on its x side, tilted 0.3 rad. Returns the JAX batch."""
    poses = [([0.0, 0.0, 0.3], 0.02), ([np.pi, 0.0, -1.2], np.pi / 2 + 0.02),
             ([0.0, 0.0, 2.0], 0.5), ([0.6, 0.0, 0.4], 0.0), ([np.pi, 0.0, 0.1], 3.13),
             ([0.0, np.pi / 2 - 0.3, 0.0], -0.05)]
    n = len(poses) * n_per
    qpos = np.tile(np.asarray(jd.qpos[0], f32), (n, 1))
    drivers = DRIVER_QPOS
    base = np.round(qpos[0, drivers] / (np.pi / 2)) * (np.pi / 2)
    for i, (euler, face) in enumerate(poses):
        rows = np.arange(i * n_per, (i + 1) * n_per)
        qpos[rows, 27:31] = tf._euler_quats([euler])[0]
        offs = np.zeros(6, f32)
        offs[i % 6] = face
        qpos[rows[:, None], drivers] = base + offs
    d = jax.tree_util.tree_map(lambda x: jnp.repeat(x[:1], n, axis=0), jd)
    return d.replace(qpos=jnp.asarray(qpos))


@pytest.mark.parametrize("mode", ["face_free", "face_curr", "full_unconstrained"])
def test_goal_distance_matches_jax(port_env, jax_env, jax_reset, mode):
    """`face_angles` and `_goal_distance` under each sampling mode on the
    reset states and on posed states, against seeded goals of both types
    (quats, face angles beyond +-pi, up axes and signs): 1e-6 abs."""
    _, state, _ = jax_reset
    pe, je = _with_mode(port_env, mode, "port"), _with_mode(jax_env, mode, "jax")
    rng = np.random.default_rng(3)
    for jd in (state.physics, _posed_states(state.physics, 2)):
        d = _port_data(jd)
        n = d.qpos.shape[0]
        _close(pe.face_angles(d), jax.jit(jax.vmap(je.face_angles))(jd))
        goal = {"cube_quat": tf._unit_quats(rng, n),
                "cube_face_angle": rng.uniform(-5, 5, (n, 6)).astype(f32),
                "goal_type": (np.arange(n) % 2).astype(np.int32),
                "axis_nr": rng.integers(0, 3, n).astype(np.int32),
                "axis_sign": rng.choice([-1.0, 1.0], n).astype(f32)}
        got = pe._goal_distance({k: _t(v) for k, v in goal.items()}, d)
        want = jax.jit(jax.vmap(je._goal_distance))({k: jnp.asarray(v) for k, v in goal.items()},
                                                    jd)
        for k in want:
            _close(got[k], want[k], msg=k)


@pytest.mark.parametrize("mode", ["face_free", "face_curr", "full_unconstrained"])
def test_next_goal_matches_jax(port_env, jax_env, jax_reset, mode):
    """`_next_goal` on posed states (`_posed_states`, 24 keys a pose) with
    the JAX keys' draws: goal quats and face angles 1e-6 abs, goal types,
    axes and signs exactly. Every branch is reached: rotation goals cw and
    ccw on each of the cube's up faces (any face under full_unconstrained),
    flips to each face, from aligned and unaligned states; a rotation goal
    turns one face by a quarter and leaves the others straight."""
    _, state, _ = jax_reset
    pe, je = _with_mode(port_env, mode, "port"), _with_mode(jax_env, mode, "jax")
    n_per = 24
    jd = _posed_states(state.physics, n_per)
    keys = split(jax.random.PRNGKey(21), jd.qpos.shape[0])
    want = jax.vmap(je._next_goal)(keys, jd)
    draws = _stack([_goal_draws(k, k) for k in keys])
    d = _port_data(jd)
    got = pe._next_goal(draws, d)
    for k in ("cube_quat", "cube_face_angle"):
        _close(got[k], want[k], msg=k)
    for k in ("goal_type", "axis_nr", "axis_sign"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert _np(got["goal_type"]).dtype == np.int32
    rotate = _np(got["goal_type"]) == 1
    rounded = _np(t_rot.round_to_straight_angles(pe.face_angles(d)))
    turned = np.abs(_np(t_rot.normalize_angles(_t(_np(got["cube_face_angle"]) - rounded))))
    face = np.argmax(turned, -1)
    np.testing.assert_allclose(turned[rotate, face[rotate]], np.pi / 2, atol=1e-5)
    turned[np.flatnonzero(rotate), face[rotate]] = 0
    _close(turned[rotate], np.zeros((rotate.sum(), 6)))
    direction = _np(draws["direction"])
    seen = {(int(f), int(dr)) for f, dr in zip(face[rotate], direction[rotate])}
    flips = set(_np(draws["face"])[~rotate].tolist())
    if mode == "full_unconstrained":
        assert rotate.all()
        np.testing.assert_array_equal(face, _np(draws["face"]))
        assert seen == {(f, dr) for f in range(6) for dr in (0, 1)}
    else:
        pose = np.arange(len(rotate)) // n_per
        aligned = ~np.isin(pose, (2, 3))
        assert not rotate[~aligned].any()
        ups = {int(f) for f in face[rotate]}
        assert len(ups) >= 2 and {dr for _, dr in seen} == {0, 1}
        assert flips == set(range(6))
        assert {bool(a) for a in aligned[~rotate]} == {True, False}


# ---------------------------------------------------------------------------
# the solver goals
# ---------------------------------------------------------------------------

def test_solver_goals_match_jax(port_env, jax_env, jax_reset, cubelets):
    """`goal_face_angles_after` and `_solver_goal` on the reset states and
    posed states with seeded plans and steps (inside the plan, at its end,
    past it, and negative): 1e-6, types and axes exactly;
    `empty_plan`; `solve_and_attach` on the reset states: the plans and
    lengths equal to the JAX package's exactly (every state legal, every
    plan non-empty), the goals 1e-6, the distances 1e-6; each env's
    `solve_plan_host` the JAX package's plan and its attached one."""
    idx, _ = cubelets
    _, state, _ = jax_reset
    rng = np.random.default_rng(9)
    for jd in (state.physics, _posed_states(state.physics, 2)):
        n = jd.qpos.shape[0]
        plan = np.stack([rng.integers(0, 3, (n, 26)), rng.integers(0, 2, (n, 26)),
                         rng.choice([-np.pi / 2, np.pi / 2, np.pi], (n, 26))], -1).astype(f32)
        length = rng.integers(0, 27, n).astype(np.int32)
        step = np.clip(length + rng.integers(-3, 3, n), -1, 30).astype(np.int32)
        aux = tuple(jnp.asarray(x) for x in (plan, length, step))
        taux = tuple(_t(x) for x in (plan, length, step))
        d = _port_data(jd)
        want = jax.vmap(lambda q, p, s: j_gs.goal_face_angles_after(jax_env.cubelets, q, p, s))(
            jd.qpos, aux[0], aux[2])
        _close(t_gs.goal_face_angles_after(idx, d.qpos, taux[0], taux[2]), want)
        got = port_env._solver_goal(d, taux)
        jgoal = jax.vmap(jax_env._solver_goal)(jd, aux)
        for k in ("cube_quat", "cube_face_angle", "axis_sign"):
            _close(got[k], jgoal[k], msg=k)
        for k in ("goal_type", "axis_nr"):
            np.testing.assert_array_equal(_np(got[k]), np.asarray(jgoal[k]), err_msg=k)
    p0, l0 = t_gs.empty_plan(3)
    jp0, jl0 = j_gs.empty_plan()
    assert p0.shape == (3,) + jp0.shape and not p0.any() and not l0.any()
    assert l0.dtype == torch.int32 and t_gs.MAX_SOLUTION_LEN == j_gs.MAX_SOLUTION_LEN

    pe = _with_mode(port_env, "face_cube_solver", "port")
    je = _with_mode(jax_env, "face_cube_solver", "jax")
    tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(state), "cpu")
    got = t_gs.solve_and_attach(pe, tstate)
    want = j_gs.solve_and_attach(je, state)
    for i, name in enumerate(("plan", "length", "step")):
        np.testing.assert_array_equal(_np(got.goal_aux[i]), np.asarray(want.goal_aux[i]),
                                      err_msg=name)
    assert (_np(got.goal_aux[1]) > 0).all()
    for i in range(B):
        plan, length = t_gs.solve_plan_host(idx, _np(tstate.physics.qpos[i]))
        jplan, jlength = j_gs.solve_plan_host(je.cubelets, np.asarray(state.physics.qpos[i]))
        np.testing.assert_array_equal(plan, jplan)
        assert int(length) == int(jlength) == int(_np(got.goal_aux[1])[i])
    for k in ("cube_quat", "cube_face_angle", "axis_sign"):
        _close(got.goal[k], want.goal[k], msg=k)
    for k in ("goal_type", "axis_nr"):
        np.testing.assert_array_equal(_np(got.goal[k]), np.asarray(want.goal[k]), err_msg=k)
    for k in want.prev_goal_distance:
        _close(got.prev_goal_distance[k], want.prev_goal_distance[k], msg=k)


# ---------------------------------------------------------------------------
# construction, reset and step
# ---------------------------------------------------------------------------

def test_settle_matches_jax(port_env, jax_env):
    """The zero-control settle computed once at construction (200
    substeps, the solved cube dropped onto the palm), against the JAX env's
    `_settled_data`, by the nudge rule (runs of the same settle from start
    qvels nudged by 1e-6, N_NUDGED of them): the cube on the palm."""
    td = bridge.data_to_numpy(port_env._settled_data)
    jd = {k: v[None] for k, v in bridge.data_to_numpy(jax_env._settled_data).items()}
    cst, m = port_env.constants, port_env.model
    d0 = make_data(m, 1)
    d0 = d0.replace(ctrl=t_hand.denormalize_position_control(
        port_env.hand, m, d0, t_hand.zero_control(1, m.dtype, m.device), relative_action=False))
    d = t_core.data_map(lambda x: x.repeat((N_NUDGED,) + (1,) * (x.dim() - 1)), d0)
    nudged = t_step.step_n(m, d.replace(qvel=tf._nudges(d0.qvel)),
                           cst.reset_initial_steps * cst.mujoco_substeps)
    assert_physics_close(td, jd, port_env.cube, tf._split(bridge.data_to_numpy(nudged), 1),
                         whole=True)
    assert bool(_np(t_cube.is_on_palm(port_env.cube, port_env._settled_data)).all())


@pytest.fixture(scope="module")
def jax_start(jax_env, jax_reset):
    """The JAX reset's scrambled start (the settled state, scrambled, its
    faces moved), as `FullPerpendicularEnv.reset_physics` makes it before
    its pose loop: a `data_to_numpy` dict of B envs."""
    keys = jax_reset[0]
    idx, settled = jax_env.cubelets, jax_env._settled_data

    def start(key):
        k_scramble, k_faceang, _ = split(split(key, 4)[0], 3)
        q = j_manip.scramble(idx, settled.qpos, k_scramble, SCRAMBLE_STEPS)
        noise = jax.random.uniform(k_faceang, (6,), jnp.float32, -0.1, 0.1)
        return settled.replace(qpos=q.at[jnp.asarray(idx.driver_qpos)].add(noise))

    return bridge.data_to_numpy(jax.jit(jax.vmap(start))(keys))


def test_scrambled_start_matches_jax(port_env, jax_env, jax_reset, jax_start):
    """`scrambled_start` on the draws of the JAX reset keys, from the JAX
    env's settled state, against the JAX reset's scrambled start: the same
    cube (the 50 turns and the face-angle noise), every other field
    equal."""
    keys = jax_reset[0]
    start, _, _ = jax_reset_draws(keys, 1)
    own = port_env._settled_data
    try:
        port_env._settled_data = t_core.data_map(lambda x: x[None],
                                                 _port_data(jax_env._settled_data))
        got = bridge.data_to_numpy(port_env.scrambled_start(B, start))
    finally:
        port_env._settled_data = own
    _assert_same_cube(got["qpos"], jax_start["qpos"], port_env.cubelets)
    rest = np.setdiff1d(np.arange(97), np.concatenate([
        np.asarray(port_env.cubelets.euler_qpos).ravel(), port_env.cubelets.driver_qpos]))
    np.testing.assert_array_equal(got["qpos"][:, rest], jax_start["qpos"][:, rest])
    np.testing.assert_array_equal(got["qvel"], jax_start["qvel"])


def _goal_quat_close(got, want, goal_type, calm, derived=True, msg="goal quat"):
    """Goal quats on the `calm` envs: a flip goal's (drawn, not derived
    from the physics) 1e-6 abs; a rotation goal's, where `derived` (under
    face_free: the cube's own orientation with its up face turned exactly
    up), within the envelope's quat tolerance ANGLE_TOL, else (a solver
    goal's face-up quat) 1e-6."""
    rotation = (np.asarray(goal_type) == 1) & derived
    got, want = _np(got), np.asarray(want)
    _close(got[calm & ~rotation], want[calm & ~rotation], msg=msg)
    _close(got[calm & rotation], want[calm & rotation], ANGLE_TOL, msg=msg)


def _compare_obs(tobs, jobs, calm, goal_type, derived=True):
    """Obs on the `calm` envs within the envelope's tolerances, the goal
    quat by `_goal_quat_close`."""
    assert sorted(tobs) == sorted(jobs)
    for k in tobs:
        t, j = _np(tobs[k]), np.asarray(jobs[k])
        assert t.shape == j.shape and np.isfinite(t).all(), k
        if k == "goal_quat":
            _goal_quat_close(t, j, goal_type, calm, derived)
        else:
            _close(t[calm], j[calm], tf.OBS_TOL.get(k, QPOS_TOL), msg=k)


def _assert_both_nudged(td, jd, idx, port_runs, jax_runs):
    """The reset's physics, port `td` against JAX `jd`: per group of the
    env-step envelope, the largest difference over the batch within the
    envelope or at most NUDGE_RATIO times the larger of the two packages'
    own largest nudged drifts (each package's runs from the same start with
    qvel nudged by NUDGE, against its own unnudged result)."""
    assert np.isfinite(td["qpos"]).all() and np.isfinite(td["qvel"]).all()
    for name, field, cols, tol in _groups(idx):
        err = _env_err(td, jd, field, cols).max()
        drift = max(max(_env_err(r, td, field, cols).max() for r in port_runs),
                    max(_env_err(r, jd, field, cols).max() for r in jax_runs))
        assert err <= max(NUDGE_RATIO * drift, tol), (name, err, drift)


def test_reset_matches_jax(port_env, jax_env, jax_reset, jax_start):
    """`reset` on the draws of the JAX reset keys, from the JAX reset's
    scrambled start (the two packages' float32 `mat2euler` can leave a
    cubelet at the gimbal lock with other euler triples for the same
    matrix, so the pose loop starts from the JAX package's), against the
    JAX reset: the physics (the warmup's 100 substeps with the cube
    dropped at a random orientation onto the palm, the pieces' 66
    friction-loss rows and some 40 live contacts against the budget of 32)
    over the whole batch by the nudge rule with both packages' nudged runs
    (`_assert_both_nudged`: in one env of this batch the JAX package's own
    nudged runs part by 2.21 rad/s in the cube's angular velocity, the
    port's by 0.70, and the two packages by 2.03), the same envs on the
    palm; the goal of the reset's draws on the JAX reset's physics equal to
    the JAX goal (1e-6, types and axes exactly), the port's goal that of
    its own physics; on the envs within the envelope, the obs within its
    tolerances; the tracker exactly."""
    keys, jstate, jobs = jax_reset
    start, attempts, draws = jax_reset_draws(keys, port_env.constants.max_pose_resets + 1)
    initial = bridge.data_from_numpy(jax_start, "cpu")
    tiled = _tile(jax_start)
    tiled["qvel"] = _np(tf._nudges(initial.qvel))
    port_runs = t_cube.CubeEnvBase.reset_physics(
        port_env, B * N_NUDGED, [{k: torch.cat([v] * N_NUDGED) for k, v in a.items()}
                                 for a in attempts],
        initial=bridge.data_from_numpy(tiled, "cpu"))
    k_pose = jnp.stack([split(split(k, 4)[0], 3)[2] for k in keys])
    loop = jax.jit(jax.vmap(lambda k, d: j_cube.CubeEnvBase.reset_physics(jax_env, k,
                                                                          initial=d)))
    with jax_boxbox_kernel():
        jax_runs = loop(jnp.concatenate([k_pose] * N_NUDGED), jax_data_from_numpy(tiled))
    port_env.scrambled_start = lambda batch, drawn: initial
    try:
        tstate, tobs = port_env.reset(B, attempts, draws, start)
    finally:
        del port_env.scrambled_start
    td, jd = bridge.data_to_numpy(tstate.physics), bridge.data_to_numpy(jstate.physics)
    _assert_both_nudged(td, jd, port_env.cube, tf._split(bridge.data_to_numpy(port_runs), B),
                        tf._split(bridge.data_to_numpy(jax_runs), B))
    np.testing.assert_array_equal(_np(t_cube.is_on_palm(port_env.cube, tstate.physics)),
                                  np.asarray(jax.vmap(lambda x: j_cube.is_on_palm(
                                      jax_env.cube, x))(jstate.physics)))
    on_jax = port_env._next_goal(draws, _port_data(jstate.physics))
    own_goal = port_env._next_goal(draws, tstate.physics)
    for k in ("cube_quat", "cube_face_angle", "goal_type", "axis_nr", "axis_sign"):
        _close(on_jax[k], jstate.goal[k], msg=k)
        assert torch.equal(tstate.goal[k], own_goal[k]), k
    for f in dataclasses.fields(t_core.TrackerState):
        np.testing.assert_array_equal(_np(getattr(tstate.tracker, f.name)),
                                      np.asarray(getattr(jstate.tracker, f.name)), err_msg=f.name)
    assert tstate.tracker.steps_by_type.shape == (B, 2)
    _compare_obs(tobs, jobs, tf._calm(td, jd, port_env.cube), jstate.goal["goal_type"])


def _compare_step(tout, jout, idx, nudged=(), goal=True, derived=True):
    """The port's step outputs against the JAX package's, as
    tests/test_torch_face.py's `_compare_step` holds them, with the six-face
    FACE_TOL and the goal's axis and sign."""
    (ts, tobs, trew, tdone, tinfo), (js, jobs, jrew, jdone, jinfo) = tout, jout
    calm = ~assert_physics_close(bridge.data_to_numpy(ts.physics),
                                  bridge.data_to_numpy(js.physics), idx, nudged)
    if not goal:
        tobs = {k: v for k, v in tobs.items() if not k.startswith("goal_")}
        jobs = {k: v for k, v in jobs.items() if not k.startswith("goal_")}
    _compare_obs(tobs, jobs, calm, js.goal["goal_type"], derived)
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
        _goal_quat_close(ts.goal["cube_quat"], js.goal["cube_quat"], js.goal["goal_type"], calm,
                         derived)
        for k in ("cube_face_angle", "axis_sign"):
            _close(_np(ts.goal[k])[calm], np.asarray(js.goal[k])[calm], msg=k)
        for k in ("goal_type", "axis_nr"):
            np.testing.assert_array_equal(_np(ts.goal[k]), np.asarray(js.goal[k]), err_msg=k)
        for k, tol in (("cube_quat", ANGLE_TOL), ("cube_face_angle", FACE_TOL)):
            _close(_np(ts.prev_goal_distance[k])[calm],
                   np.asarray(js.prev_goal_distance[k])[calm], tol, msg=k)
    return calm


def _step_with_nudges(env, tstate, action, draws):
    """The port's step, and the physics (`data_to_numpy` dicts) of its
    N_NUDGED runs from qvels nudged by NUDGE, stepped as one batch."""
    tiled = bridge.env_state_from_numpy(_tile(bridge.env_state_to_numpy(tstate)), "cpu")
    tiled = tiled.replace(physics=tiled.physics.replace(qvel=tf._nudges(tstate.physics.qvel)))
    out = env.step(tiled, torch.cat([action] * N_NUDGED),
                   draws={k: torch.cat([v] * N_NUDGED) for k, v in draws.items()})
    return (env.step(tstate, action, draws=draws),
            tf._split(bridge.data_to_numpy(out[0].physics), tstate.t.shape[0]))


def test_step_matches_jax(port_env, jax_reset, jax_step):
    """Two env steps at B=4, each from the JAX state carried across by the
    bridge, with the same actions and the JAX keys' draws, held as
    `_compare_step` holds them."""
    _, jstate, jobs = jax_reset
    tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
    assert tstate.goal["goal_type"].dtype == torch.int32
    tobs = port_env._observe(tstate)
    for k in tobs:
        _close(tobs[k], jobs[k], msg=k)
    rng = np.random.default_rng(7)
    for _ in range(2):
        tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
        action = rng.uniform(-1, 1, (B, 20)).astype(f32)
        tout, nudged = _step_with_nudges(port_env, tstate, _t(action),
                                         jax_step_draws(jstate.key))
        jout = jax_step(jstate, jnp.asarray(action))
        _compare_step(tout, jout, port_env.cube, nudged)
        jstate = jout[0]


def _goal_reached(jax_env, jstate, jax_step, action):
    """`jstate` with each env's goal its cube orientation and face angles
    after the step, so that every env succeeds on it."""
    after = jax_step(jstate, jnp.asarray(action))[0]
    return jstate.replace(goal=dict(
        jstate.goal, cube_quat=jax.vmap(lambda d: j_cube.cube_quat(jax_env.cube, d))(after.physics),
        cube_face_angle=jax.vmap(jax_env.face_angles)(after.physics),
        goal_type=jnp.zeros_like(jstate.goal["goal_type"])))


def test_step_goal_resample_matches_jax(port_env, jax_env, jax_reset, jax_step):
    """A state whose goal is each env's cube orientation and face angles
    after the step (a flip goal, so the full quat distance counts), with
    a hold of one step, so that every env reaches its goal and resamples
    it: with the JAX keys' draws every output matches as in
    `test_step_matches_jax`, the new goals among them; with the port's own
    draws every output but the new goal, and each new goal is a unit quat
    with w >= 0, its faces on multiples of pi/2, its type 0 or 1."""
    _, jstate, _ = jax_reset
    action = np.random.default_rng(8).uniform(-1, 1, (B, 20)).astype(f32)
    jstate = _goal_reached(jax_env, jstate, jax_step, action)
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


def test_solver_step_matches_jax(port_env, jax_env, jax_reset):
    """One release_cube_solver step from the reset state with its plans
    attached (`solve_and_attach`), each env's goal made the cube's state
    after the step: env 0 with its plan emptied, env 1 at the end of its
    plan (the tighter face threshold, a reached goal ending the trial as
    solved), the others inside it (the step advancing); every output held
    as `_compare_step` holds them, the plan and the three solver info
    flags (`solver_plan_empty`, `solver_plan_step`, `solver_replan_needed`)
    exactly."""
    _, state, _ = jax_reset
    mode = "release_cube_solver"
    pe, je = _with_mode(port_env, mode, "port"), _with_mode(jax_env, mode, "jax")
    jstate = j_gs.solve_and_attach(je, state)
    plan, length, step = jstate.goal_aux
    length = length.at[0].set(0)
    step = step.at[1].set(length[1])
    jstate = jstate.replace(goal_aux=(plan, length, step))
    jstep = jax.jit(jax.vmap(je.step))
    action = np.random.default_rng(10).uniform(-1, 1, (B, 20)).astype(f32)
    with jax_boxbox_kernel():
        jstate = _goal_reached(je, jstate, jstep, action)
        jout = jstep(jstate, jnp.asarray(action))
    tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
    assert isinstance(tstate.goal_aux, tuple) and len(tstate.goal_aux) == 3
    assert tstate.goal_aux[1].dtype == tstate.goal_aux[2].dtype == torch.int32
    tout, nudged = _step_with_nudges(pe, tstate, _t(action), jax_step_draws(jstate.key))
    _compare_step(tout, jout, pe.cube, nudged, derived=False)
    for i in range(3):
        np.testing.assert_array_equal(_np(tout[0].goal_aux[i]), np.asarray(jout[0].goal_aux[i]))
    for k in ("solver_plan_empty", "solver_plan_step", "solver_replan_needed"):
        assert _np(tout[4][k]).dtype == np.asarray(jout[4][k]).dtype, k
    # the cases reached, on the JAX package's outputs
    np.testing.assert_array_equal(np.asarray(jout[4]["solver_plan_empty"]),
                                  [True] + [False] * (B - 1))
    assert np.asarray(jout[4]["sub_goal_is_successful"]).all()
    np.testing.assert_array_equal(np.asarray(jout[4]["solver_plan_step"])[2:],
                                  np.asarray(step)[2:] + 1)
    assert bool(np.asarray(jout[0].tracker.trial_success)[1])


# ---------------------------------------------------------------------------
# the cube-size transform and the full stack
# ---------------------------------------------------------------------------

tw.DRAWS.append((j_param.RandomizedPerpendicularCubeSizeWrapper,
                 {"model": lambda t, k, ts, o: {"u": tw._u(k)}}))


def test_cube_size_transform_matches_jax(port_env, jax_env):
    """`RandomizedPerpendicularCubeSizeWrapper` selects exactly the 26
    piece geoms and bodies (`cube:cubelet*`), the JAX transform's ids, and
    its per-episode `geom_size` and `body_pos` equal the JAX transform's on
    the JAX keys' draw (1e-6 relative); every other geom and body keeps
    its own."""
    tj = j_param.RandomizedPerpendicularCubeSizeWrapper(env=jax_env)
    tp = TW.RandomizedPerpendicularCubeSizeWrapper(env=port_env)
    c = port_env.model.const
    pieces = sorted(i for n, i in c.names["geom"].items() if n.startswith("cube:cubelet"))
    assert len(pieces) == 26
    np.testing.assert_array_equal(tp.geom_ids, pieces)
    np.testing.assert_array_equal(tp.geom_ids, tj.geom_ids)
    np.testing.assert_array_equal(tp.body_ids, tj.body_ids)
    assert len(tp.body_ids) == 26
    assert tuple(tp.model_fields) == tuple(tj.model_fields) == ("geom_size", "body_pos")
    keys = split(jax.random.PRNGKey(5), B)
    want = jax.vmap(lambda k: tj.model(None, jax_env.model, k))(keys)
    m = port_env.model
    fields = {"geom_size": m.geom_size.expand(B, -1, -1).clone(),
              "body_pos": m.body_pos.expand(B, -1, -1).clone()}
    got = tp.model(None, fields, tw.jax_draws(tj, "model", keys))
    for k in ("geom_size", "body_pos"):
        tw.assert_tree_close(got[k], getattr(want, k), k, atol=1e-12, rtol=1e-6)
    other = np.setdiff1d(np.arange(c.ngeom), pieces)
    assert torch.equal(got["geom_size"][:, other], fields["geom_size"][:, other])
    size = got["geom_size"][:, pieces]
    assert bool((size.amax(0) > size.amin(0)).all())


@contextlib.contextmanager
def _full_world_sizes():
    """`test_torch_wrappers`' draw table sized for the full world's bodies
    and tendons while inside."""
    arrays = snapshot_arrays(rubik_full_like.SNAPSHOT)
    old = tw.NBODY, tw.NTENDON
    tw.NBODY, tw.NTENDON = (int(arrays["const." + k]) for k in ("nbody", "ntendon"))
    try:
        yield
    finally:
        tw.NBODY, tw.NTENDON = old


@pytest.fixture(scope="module")
def wrapped(port_env, jax_env):
    """(JAX full env in the face stack plus the cube-size transform, the
    port's on the CPU)."""
    wl = (JW.construct_default_dactyl_wrappers(randomize=True)
          + [["RandomizedFaceDampingWrapper"], [j_param.RandomizedPerpendicularCubeSizeWrapper]])
    assert [w[0] for w in TW.construct_full_wrappers(randomize=True)[:-1]] == [
        w[0] for w in wl[:-1]]
    assert TW.construct_full_wrappers(randomize=True)[-1] == [
        "RandomizedPerpendicularCubeSizeWrapper"]
    return JW.apply_named_wrappers(jax_env, wl), TW.apply_full_wrappers(port_env, randomize=True)


# the fields the stack overrides that the full world leaves equal across
# envs, and why (chip_smoke.FULL_WRAPPED_SAME)
FULL_SAME = {"body_pos", "tendon_range"}


@pytest.fixture(scope="module")
def jax_wrapped_reset(wrapped, jax_reset_fn):
    """The JAX wrapped reset at B from seeded keys, and its inner env's
    reset (each key's first split), the inner reset run once through the
    module's compiled reset: (keys, state, obs, inner state, inner obs)."""
    jw, _ = wrapped
    keys = split(jax.random.PRNGKey(13), B)
    inner_keys = jnp.stack([split(k, 4)[0] for k in keys])
    inner, inner_obs = jax_reset_fn(inner_keys)
    env = jw.env

    class Inner:
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


def test_wrapped_full_reset_matches_jax(wrapped, jax_wrapped_reset):
    """`wrap_reset` on the JAX env's own reset state with the JAX draws:
    observations and transform states to 1e-6 abs, the 12 model fields to
    1e-6 relative; `body_pos` (the pieces' bodies sit at the cube's
    origin, which the scale leaves there) and `tendon_range` equal across
    envs in both packages and the timestep the compiled one until the first
    step; `geom_size` differs across envs on exactly the 26 piece geoms,
    `dof_damping` on exactly the 6 driver dofs."""
    jw, pw = wrapped
    keys, jstate, jobs, inner, inner_obs = jax_wrapped_reset
    n = len(jw.transforms)
    assert n == 32 and isinstance(pw.transforms[-1], TW.RandomizedPerpendicularCubeSizeWrapper)
    k4 = tw._key_splits(keys, 4)
    ki, km, ko = (tw._key_splits(k4[:, j], n) for j in (1, 2, 3))
    with _full_world_sizes():
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
        assert same == (k in FULL_SAME | {"opt:timestep"}), k
        if same:
            assert torch.equal(v[0], model_field(pw.env.model, k)), k
    size = got_state.model_fields["geom_size"]
    varied = np.flatnonzero(_np((size.amax(0) > size.amin(0)).any(-1)))
    np.testing.assert_array_equal(varied, pw.transforms[-1].geom_ids)
    damp = got_state.model_fields["dof_damping"]
    varied = np.flatnonzero(_np(damp.amax(0) > damp.amin(0)))
    np.testing.assert_array_equal(varied[varied >= 24], sorted(pw.transforms[-2].dof_ids))
    assert len(pw.transforms[-2].dof_ids) == 6


def test_wrapped_full_steps_match_jax(wrapped, jax_wrapped_reset):
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
        with _full_world_sizes():
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
