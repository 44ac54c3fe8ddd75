"""The port's vision observations against the JAX package's, on the CPU:
the camera and light randomization (`randomization/vision.py`), the
locked env's `"raycast"` provider, the real-image locked env
(`envs/dactyl/locked_real_image.py`) and the blocks env's vision keys.

Worlds: the stand-ins with cameras of `robogym_torch/worlds/vision_like.py`
(the JAX envs built on their XML as tests/test_torch_env.py builds the
locked env). B=4 envs, 32-pixel images. Randomization: the fields of
`sample_vision_fields` under `jax.vmap` against `apply_vision` on the
draws of the same keys (the fovy's and lights' uniforms in float32, the
position's normals, the axis quaternion's uniforms in float64 as
conftest's x64 makes `uniform_quat` draw them), 1e-6. The locked env with
the raycast provider and vision randomization: the reset's observations on
the JAX reset state carried across, its fields from the JAX keys, and two
steps from the JAX state (physics by the nudge rule of
tests/test_torch_env.py's `_compare_step`); images within 1 level on at
least 99.5 % of the pixels (tests/test_torch_render.py's rule). The real-
image env: the rendered pool from the JAX pool's draws, the pool's goals
taken in turn (`goal_idx`) through forced resamples. The blocks env's
`vision_obs`, `vision_obs_mobile` and `vision_goal` on seeded states. The
STEP and RESET_GOAL vision providers of `observation/vision.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_env as tenv
from _torch_common import jax_boxbox_kernel, nudged_runs, snapshot_jax_model, snapshot_model
from robogym_torch import bridge
from robogym_torch.envs.dactyl import locked as t_locked
from robogym_torch.envs.dactyl import locked_real_image as t_real
from robogym_torch.envs.rearrange import blocks as t_blocks
from robogym_torch.envs.rearrange import simulation as t_sim
from robogym_torch.randomization import vision as t_vr
from robogym_torch.worlds import vision_like
from robogym_tpu.envs.dactyl import cube_env as j_cube
from robogym_tpu.envs.dactyl import locked as j_locked
from robogym_tpu.envs.dactyl import locked_real_image as j_real
from robogym_tpu.envs.rearrange import blocks as j_blocks
from robogym_tpu.envs.rearrange import simulation as j_sim
from robogym_tpu.randomization import vision as j_vr
from test_torch_render import assert_images_close

B = 4
SIZE = 32
VISION_RAND = dict(camera_fovy_radius=3.0, camera_pos_radius=0.02, camera_quat_radius=0.05,
                   light_pos_range=0.4, light_diffuse_intensity=0.5,
                   light_ambient_intensity=0.15)
RAYCAST = dict(vision_observation_provider="raycast", vision_image_size=SIZE, **VISION_RAND)
IMAGES = ("vision", "vision_goal")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def jax_vision_draws(keys, nc, nl):
    """`draw_vision`'s draws from the JAX keys of `sample_vision_fields`."""
    out = {k: [] for k in ("fovy_u", "pos_n", "axis_u", "light_u")}
    for key in keys:
        k_fovy, k_pos, k_axis, k_light = jax.random.split(key, 4)
        out["fovy_u"].append(np.asarray(jax.random.uniform(k_fovy, (nc,), jnp.float32)))
        out["pos_n"].append(np.asarray(jax.random.normal(k_pos, (nc, 3), jnp.float32)))
        axis = []
        for k in jax.random.split(k_axis, nc):
            k1, k2, k3 = jax.random.split(k, 3)
            axis.append([float(jax.random.uniform(kk)) for kk in (k1, k2, k3)])
        out["axis_u"].append(np.asarray(axis, np.float64).reshape(nc, 3))
        light = []
        for k in jax.random.split(k_light, nl):
            light.append([float(jax.random.uniform(kk, (), jnp.float32))
                          for kk in jax.random.split(k, 3)])
        out["light_u"].append(np.asarray(light, np.float32).reshape(nl, 3))
    return {k: torch.as_tensor(np.stack(v)) for k, v in out.items()}


@pytest.mark.parametrize("snapshot", [vision_like.DACTYL_SNAPSHOT,
                                      vision_like.REARRANGE_SNAPSHOT])
def test_vision_fields_from_the_jax_draws(snapshot):
    jm, tm = snapshot_jax_model(snapshot), snapshot_model(snapshot)
    assert jm.const.ncam and jm.const.nlight
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    for params in (VISION_RAND, {}):
        jp, tp = j_vr.VisionRandomizationParams(**params), t_vr.VisionRandomizationParams(**params)
        assert jp.any_active() == tp.any_active()
        want = jax.vmap(lambda k: j_vr.sample_vision_fields(k, jm, jp))(keys)
        got = t_vr.apply_vision(tm, jax_vision_draws(keys, jm.const.ncam, jm.const.nlight), tp)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=0, atol=1e-6,
                                       err_msg=k)
            assert got[k].shape[0] == B
    draws = t_vr.draw_vision(torch.Generator().manual_seed(0), B, tm)
    assert draws["fovy_u"].shape == (B, tm.const.ncam) and draws["light_u"].shape == (
        B, tm.const.nlight, 3)


# ---------------------------------------------------------------------------
# the locked env with raycast images
# ---------------------------------------------------------------------------

def _jax_locked(cls, cst, tmp_path_factory):
    xml = vision_like.write_dactyl(str(tmp_path_factory.mktemp("dactyl_vision")))
    orig = j_cube.build_cube_world_xml
    j_cube.build_cube_world_xml = lambda *a, **kw: xml
    try:
        with jax_boxbox_kernel():
            return cls(cst, dtype=jnp.float32)
    finally:
        j_cube.build_cube_world_xml = orig


@pytest.fixture(scope="module")
def port_env():
    return t_locked.make_env(RAYCAST, device="cpu", seed=0,
                             snapshot=vision_like.DACTYL_SNAPSHOT)


@pytest.fixture(scope="module")
def jax_env(tmp_path_factory):
    return _jax_locked(j_locked.LockedEnv, j_locked.LockedEnvConstants(**RAYCAST),
                       tmp_path_factory)


@pytest.fixture(scope="module")
def jax_reset(jax_env):
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    with jax_boxbox_kernel():
        state, obs = jax.jit(jax.vmap(jax_env.reset))(keys)
    return keys, state, obs


def _jax_step_fn(env):
    step = jax.jit(jax.vmap(env.step))

    def run(state, action):
        with jax_boxbox_kernel():
            return step(state, action)

    return run


def _without_images(out):
    state, obs, *rest = out
    return (state, {k: v for k, v in obs.items() if k not in IMAGES}, *rest)


def _assert_obs_images(tobs, jobs, what):
    for k in IMAGES:
        assert tobs[k].dtype == torch.uint8 and tuple(tobs[k].shape) == (B, 3, SIZE, SIZE, 3)
        assert_images_close(_np(tobs[k]).reshape(-1, SIZE, SIZE, 3),
                            np.asarray(jobs[k]).reshape(-1, SIZE, SIZE, 3), f"{what} {k}")


def test_raycast_reset_matches_jax(port_env, jax_env, jax_reset):
    """The reset's observations on the JAX reset state carried across
    (per-env camera and light fields in its model fields), the images
    showing the scene (not the background alone, the hand hidden in the
    goal image); the port's own reset draws the JAX reset's fields from
    the JAX keys."""
    keys, jstate, jobs = jax_reset
    tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
    assert sorted(tstate.model_fields) == sorted(jstate.model_fields)
    tobs = port_env._observe(tstate)
    assert sorted(tobs) == sorted(jobs)
    _assert_obs_images(tobs, jobs, "reset")
    img = _np(tobs["vision"]).astype(int)
    assert (img.std(axis=(2, 3, 4)) > 5).all()
    # the goal image hides the hand: fewer pixels differ from the background
    assert (img != _np(tobs["vision_goal"]).astype(int)).any()
    attempts, draws = tenv.jax_reset_draws(keys, port_env.constants.max_pose_resets + 1)
    k_vis = [jax.random.split(k, 5)[4] for k in keys]
    own, obs = port_env.reset(B, attempts, draws,
                              jax_vision_draws(k_vis, port_env.model.const.ncam,
                                               port_env.model.const.nlight))
    for k, v in jstate.model_fields.items():
        np.testing.assert_allclose(_np(own.model_fields[k]), np.asarray(v), rtol=0, atol=1e-6,
                                   err_msg=k)
    assert sorted(own.goal_aux[1]) == ["goal_vision"]


def test_raycast_two_steps_match_jax(port_env, jax_env, jax_reset):
    """Two steps from the JAX state carried across, one of them with envs
    0 and 2 resampling their goals (their goal images rendered again)."""
    _, jstate, _ = jax_reset
    step = _jax_step_fn(jax_env)
    rng = np.random.default_rng(7)
    for i in range(2):
        if i == 1:
            pending = jnp.asarray([True, False, True, False])
            jstate = jstate.replace(tracker=jstate.tracker.replace(
                success_and_no_goal_reset=pending))
        action = rng.uniform(-1, 1, (B, 20)).astype(np.float32)
        tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")

        def run(qvel, tstate=tstate, action=action):
            return _without_images(port_env.step(
                tstate.replace(physics=tstate.physics.replace(qvel=qvel)), tenv._t(action),
                draws=tenv.jax_step_draws(jstate)))

        tout = port_env.step(tstate, tenv._t(action), draws=tenv.jax_step_draws(jstate))
        jout = step(jstate, jnp.asarray(action))
        tenv._compare_step(_without_images(tout), _without_images(jout), port_env.cube,
                           nudged=nudged_runs(run, tstate.physics.qvel))
        _assert_obs_images(tout[1], jout[1], f"step {i}")
        jstate = jout[0]


# ---------------------------------------------------------------------------
# the real-image env
# ---------------------------------------------------------------------------

POOL = 3
REAL = dict(vision_image_size=SIZE, goal_pool_size=POOL)


def _pool_draws():
    """The JAX env's pool draws (keys of jax.random.key(17)) as
    `draw_parallel_goal` gives them."""
    u, choice = [], []
    for k in jax.random.split(jax.random.key(j_real_pool_seed()), POOL):
        kz, kp = jax.random.split(k)
        u.append(float(jax.random.uniform(kz, (), jnp.float32)))
        choice.append(int(jax.random.randint(kp, (), 0, 24)))
    return torch.tensor(u, dtype=torch.float32), torch.tensor(choice)


def j_real_pool_seed():
    return 17


@pytest.fixture(scope="module")
def real_envs(tmp_path_factory):
    jenv = _jax_locked(j_real.LockedRealImageEnv, j_real.LockedRealImageEnvConstants(**REAL),
                       tmp_path_factory)
    with np.load(vision_like.DACTYL_SNAPSHOT) as z:
        model = bridge.model_from_numpy({k: z[k] for k in z.files}, "cpu")
    tenv_ = t_real.LockedRealImageEnv(t_real.LockedRealImageEnvConstants(**REAL), model,
                                      pool_draws=_pool_draws())
    return tenv_, jenv


def test_real_image_pool_matches_jax(real_envs):
    tenv_, jenv = real_envs
    np.testing.assert_allclose(_np(tenv_.pool_quats), np.asarray(jenv.pool_quats), rtol=0,
                               atol=1e-6)
    assert tenv_.pool_images.shape == (POOL, 3, SIZE, SIZE, 3)
    assert_images_close(_np(tenv_.pool_images).reshape(-1, SIZE, SIZE, 3),
                        np.asarray(jenv.pool_images).reshape(-1, SIZE, SIZE, 3), "pool")


def test_real_image_goals_cycle_like_jax(real_envs):
    """Reset and two steps from the JAX state, every env resampling at the
    second and third: `goal_idx` 0, 1, 2, then back to 0 after the pool's
    last goal; the goal quat and the served image the pool's; physics by
    the nudge rule."""
    tenv_, jenv = real_envs
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    with jax_boxbox_kernel():
        jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    assert (np.asarray(jstate.goal["goal_idx"]) == 0).all()
    step = _jax_step_fn(jenv)
    seen = [0]
    for i in range(3):
        jstate = jstate.replace(tracker=jstate.tracker.replace(
            success_and_no_goal_reset=jnp.ones(B, bool)))
        tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
        action = np.zeros((B, 20), np.float32)
        tout = tenv_.step(tstate, tenv._t(action), draws=tenv.jax_step_draws(jstate))
        jout = step(jstate, jnp.asarray(action))

        def run(qvel, tstate=tstate):
            return _without_images(tenv_.step(
                tstate.replace(physics=tstate.physics.replace(qvel=qvel)), tenv._t(action),
                draws=tenv.jax_step_draws(jstate)))

        tenv._compare_step(_without_images(tout), _without_images(jout), tenv_.cube,
                           nudged=nudged_runs(run, tstate.physics.qvel))
        idx = _np(tout[0].goal["goal_idx"])
        np.testing.assert_array_equal(idx, np.asarray(jout[0].goal["goal_idx"]))
        seen.append(int(idx[0]))
        np.testing.assert_array_equal(_np(tout[1]["vision_goal"]),
                                      _np(tenv_.pool_images[torch.as_tensor(idx)]))
        jstate = jout[0]
    assert seen == [0, 1, 2, 0]


def test_real_image_reads_a_goal_npz(tmp_path):
    """A pool in the reference's npz format: "quats" and one image array
    a camera; the env serves its images in turn."""
    rng = np.random.default_rng(0)
    quats = rng.standard_normal((2, 4))
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    imgs = {c: rng.integers(0, 255, (2, SIZE, SIZE, 3), dtype=np.uint8)
            for c in ("vision_cam_top", "vision_cam_right", "vision_cam_left")}
    path = tmp_path / "goals.npz"
    np.savez(path, quats=quats, **imgs)
    env = t_real.make_env(dict(REAL, goal_data_path=str(path)), device="cpu")
    np.testing.assert_allclose(_np(env.pool_quats), quats, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(env.pool_images[1, 2]), imgs["vision_cam_left"][1])
    state, obs = env.reset(2)
    np.testing.assert_array_equal(_np(obs["vision_goal"]), _np(env.pool_images[[0, 0]]))


# ---------------------------------------------------------------------------
# the blocks env's vision keys
# ---------------------------------------------------------------------------

def test_blocks_vision_keys_match_jax():
    """`_observe_vision` of both packages' blocks env (objects carrying
    only what it reads) on the UR16e-shaped vision world, seeded object
    poses and goals: `vision_obs`, `vision_obs_mobile` and `vision_goal`
    (the robot hidden)."""
    from test_torch_rearrange_goals import World

    w = World(vision_like.REARRANGE_SNAPSHOT, 2)
    cst_kw = dict(vision=True, vision_image_size=SIZE)
    jenv = object.__new__(j_blocks.BlocksRearrangeEnv)
    jenv.__dict__.update(constants=j_blocks.RearrangeEnvConstants(**cst_kw), idx=w.jidx)
    tenv_ = object.__new__(t_blocks.BlocksRearrangeEnv)
    tenv_.__dict__.update(constants=t_blocks.RearrangeEnvConstants(**cst_kw), idx=w.tidx)
    rng = np.random.default_rng(4)
    gpos = np.asarray(w.jd.xpos)[:, w.jidx.object_body_ids] + rng.uniform(
        -0.05, 0.05, (16, w.O, 3))
    q = rng.standard_normal((16, w.O, 4))
    gquat = (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)
    jq = jax.vmap(lambda d, p, r: j_sim.goal_qpos(w.jidx, d, p, r))(
        w.jd, jnp.asarray(gpos, jnp.float32), jnp.asarray(gquat))
    tq = t_sim.goal_qpos(w.tidx, w.td, torch.as_tensor(gpos, dtype=torch.float32),
                         torch.as_tensor(gquat))
    np.testing.assert_allclose(_np(tq), np.asarray(jq), rtol=0, atol=1e-6)
    envs = slice(0, B)
    jd = jax.tree_util.tree_map(lambda x: x[envs], w.jd)
    td = bridge.data_from_numpy(bridge.data_to_numpy(jd), "cpu")
    want = jax.vmap(lambda d, qg: jenv._observe_vision(w.jm, d, qg))(jd, jq[envs])
    got = tenv_._observe_vision(w.tm, td, tq[envs])
    assert sorted(got) == sorted(want) == ["vision_goal", "vision_obs", "vision_obs_mobile"]
    for k in want:
        assert got[k].shape == (B, 1, SIZE, SIZE, 3)
        assert_images_close(_np(got[k])[:, 0], np.asarray(want[k])[:, 0], k)
    assert (_np(got["vision_obs"]) != _np(got["vision_goal"])).any()


def test_vision_providers_match_jax():
    """`make_vision_provider` and `make_goal_vision_provider` (the goal state
    with the robot hidden) on the dactyl vision stand-in against the JAX
    package's providers under `jax.vmap`, images as above; their cadences
    are the JAX providers'."""
    import types

    from robogym_torch.observation import vision as t_vis
    from robogym_tpu.mjcf.model import make_data as j_make_data
    from robogym_tpu.observation import vision as j_vis
    from robogym_tpu.physics import step as j_step

    jm, tm = snapshot_jax_model(vision_like.DACTYL_SNAPSHOT), snapshot_model(
        vision_like.DACTYL_SNAPSHOT)
    rng = np.random.default_rng(8)
    d = jax.vmap(lambda _: j_make_data(jm, dtype=jnp.float32))(jnp.arange(2))
    qpos = np.asarray(d.qpos) + 0.05 * rng.standard_normal(d.qpos.shape).astype(np.float32)
    jd = jax.vmap(lambda dd: j_step.fwd_position(jm, dd))(d.replace(qpos=jnp.asarray(qpos)))
    td = bridge.data_from_numpy(bridge.data_to_numpy(jd), "cpu")
    cams = ("vision_cam_top", "vision_cam_left")
    goal = qpos.copy()
    goal[:, -7:-4] += 0.02

    def j_goal(env, st):
        return st.physics.qpos.at[-7:-4].add(0.02)

    def t_goal(env, st):
        return torch.as_tensor(goal)

    for make, extra in (("make_vision_provider", ()), ("make_goal_vision_provider",
                                                       ("goal",))):
        jp = getattr(j_vis, make)(cams, SIZE, *([j_goal] if extra else []))
        tp = getattr(t_vis, make)(cams, SIZE, *([t_goal] if extra else []))
        assert (tp.name, tp.sync_type.name) == (jp.name, jp.sync_type.name)
        want = jax.vmap(lambda dd: jp.read(types.SimpleNamespace(model=jm),
                                           types.SimpleNamespace(physics=dd,
                                                                 model_fields=None)))(jd)
        got = tp.read(types.SimpleNamespace(model=tm),
                      types.SimpleNamespace(physics=td, model_fields=None))
        (key, w), = want.items()
        assert list(got) == [key] and got[key].shape == (2, 2, SIZE, SIZE, 3)
        assert_images_close(_np(got[key]).reshape(-1, SIZE, SIZE, 3),
                            np.asarray(w).reshape(-1, SIZE, SIZE, 3), make)
