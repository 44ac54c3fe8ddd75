"""The port's observation stack and the locked env's dummy-vision
observations against the JAX package's, on the CPU.

`ObservationStack.sync` is held to the JAX stack under `jax.vmap` with
providers of all three cadences that read the goal, so that what each
sync level refreshes, and what it keeps, shows in the cache; the port's
sync on a subset of envs replaces those envs' rows only. Then the locked
env with `vision_observation_provider="dummy_vision"` on the dactyl-shaped
world (`robogym_torch/worlds/dactyl_locked_like.py`, the JAX env built on
it as tests/test_torch_env.py builds it) at B=4 and 16-pixel images: the
reset's observations and cache, two steps and a forced goal resample from
the JAX state carried across by the bridge (the cache rides in
`goal_aux` as `(inner goal_aux, cache)`), every observation key against
the JAX env's: images exactly, the rest as tests/test_torch_env.py holds
them (its `_compare_step`: physics by the nudge rule, obs within the
tolerances of the env-step envelope)."""

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_env as tenv
from _torch_common import jax_boxbox_kernel, nudged_runs
from robogym_torch import bridge
from robogym_torch.envs import core as t_core
from robogym_torch.envs.dactyl import locked as t_locked
from robogym_torch.observation import common as t_obs
from robogym_torch.observation import dummy_vision as t_dv
from robogym_torch.worlds import dactyl_locked_like
from robogym_tpu.envs.dactyl import cube_env as j_cube
from robogym_tpu.envs.dactyl import locked as j_locked
from robogym_tpu.observation import common as j_obs
from robogym_tpu.observation import dummy_vision as j_dv

B = 4
SIZE = 16
VISION = {"vision_observation_provider": "dummy_vision", "vision_image_size": SIZE}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ---------------------------------------------------------------------------
# the stack's cadence
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Goal:
    """A state with a goal only, as these providers read it."""

    goal: Any


def _providers(lib):
    cadence = lib.SyncType
    return {
        "step_p": lib.ObservationProvider("step_p", lambda env, s: {"s": s.goal * 1.0},
                                          cadence.STEP),
        "goal_p": lib.ObservationProvider("goal_p", lambda env, s: {"gg": s.goal + 1.0},
                                          cadence.RESET_GOAL),
        "reset_p": lib.ObservationProvider("reset_p", lambda env, s: {"r": s.goal * 2.0},
                                           cadence.RESET),
    }


def _assert_trees(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert sorted(got[k]) == sorted(want[k])
        for kk in want[k]:
            np.testing.assert_array_equal(_np(got[k][kk]), np.asarray(want[k][kk]),
                                          err_msg=f"{k}.{kk}")


def test_sync_cadence_matches_jax():
    """A RESET sync reads the RESET and RESET_GOAL providers; a RESET_GOAL
    sync reads both again (the JAX rule: a provider is due where the sync
    level is at most its cadence); a STEP sync reads both. Each against
    the JAX stack under vmap, whose cache also holds a STEP provider's
    entry, read at the first reset to keep its structure fixed: the
    port's cache has none (a STEP provider is read at observe time)."""
    rng = np.random.default_rng(0)
    goals = [rng.standard_normal((B, 3)).astype(np.float32) for _ in range(3)]
    jstack = j_obs.ObservationStack(_providers(j_obs))
    tstack = t_obs.ObservationStack(_providers(t_obs))
    jcache = tcache = None
    for g, level in zip(goals, ("RESET", "RESET_GOAL", "STEP")):
        jlevel, tlevel = getattr(j_obs.SyncType, level), getattr(t_obs.SyncType, level)
        if jcache is None:
            jcache = jax.vmap(lambda x: jstack.sync(None, Goal(x), None, jlevel))(jnp.asarray(g))
        else:
            jcache = jax.vmap(lambda x, c: jstack.sync(None, Goal(x), c, jlevel))(
                jnp.asarray(g), jcache)
        tcache = tstack.sync(None, Goal(torch.as_tensor(g)), tcache, tlevel)
        assert "step_p" in jcache
        _assert_trees(tcache, {k: v for k, v in jcache.items() if k != "step_p"})
    np.testing.assert_array_equal(_np(tcache["goal_p"]["gg"]), goals[2] + 1.0)
    np.testing.assert_array_equal(_np(tcache["reset_p"]["r"]), goals[2] * 2.0)


def test_sync_on_some_envs_replaces_their_rows_only():
    """A RESET_GOAL sync of envs 1 and 3 (their states only): their rows of
    the RESET_GOAL and RESET entries read the new goal, every other row
    stays as cached, and no STEP entry is made; a sync with no env due
    leaves the cache's tensors themselves in place."""
    rng = np.random.default_rng(1)
    g0, g1 = (torch.as_tensor(rng.standard_normal((B, 3)).astype(np.float32)) for _ in range(2))
    stack = t_obs.ObservationStack(_providers(t_obs))
    cache = stack.sync(None, Goal(g0), None, t_obs.SyncType.RESET)
    envs = torch.tensor([1, 3])
    new = stack.sync(None, t_core.take_envs(Goal(g1), envs), cache, t_obs.SyncType.RESET_GOAL,
                     envs=envs)
    mixed = g0.clone()
    mixed[envs] = g1[envs]
    np.testing.assert_array_equal(_np(new["goal_p"]["gg"]), _np(mixed + 1.0))
    np.testing.assert_array_equal(_np(new["reset_p"]["r"]), _np(mixed * 2.0))
    assert "step_p" not in new and "step_p" not in cache
    np.testing.assert_array_equal(_np(cache["goal_p"]["gg"]), _np(g0 + 1.0))


def test_dummy_images_match_jax():
    cams = j_dv.DEFAULT_CAMERA_NAMES
    assert t_dv.DEFAULT_CAMERA_NAMES == cams
    got = t_dv.zero_images(cams, SIZE, B)
    want = jax.vmap(lambda _: j_dv.zero_images(cams, SIZE))(jnp.arange(B))
    assert got.dtype == torch.uint8 and tuple(got.shape) == tuple(want.shape) == (B, 3, SIZE,
                                                                                    SIZE, 3)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    for make in ("make_dummy_vision_provider", "make_dummy_goal_vision_provider"):
        tp, jp = getattr(t_dv, make)(image_size=SIZE), getattr(j_dv, make)(image_size=SIZE)
        assert (tp.name, tp.sync_type.name) == (jp.name, jp.sync_type.name)


# ---------------------------------------------------------------------------
# the locked env with dummy vision
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def port_env():
    return t_locked.make_env(VISION, device="cpu", seed=0)


@pytest.fixture(scope="module")
def jax_env(tmp_path_factory):
    xml = dactyl_locked_like.write(str(tmp_path_factory.mktemp("dactyl_vision")))
    orig = j_cube.build_cube_world_xml
    j_cube.build_cube_world_xml = lambda *a, **kw: xml
    try:
        with jax_boxbox_kernel():
            return j_locked.LockedEnv(j_locked.LockedEnvConstants(**VISION), dtype=jnp.float32)
    finally:
        j_cube.build_cube_world_xml = orig


@pytest.fixture(scope="module")
def jax_reset(jax_env):
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    with jax_boxbox_kernel():
        state, obs = jax.jit(jax.vmap(jax_env.reset))(keys)
    return keys, state, obs


@pytest.fixture(scope="module")
def jax_step(jax_env):
    step = jax.jit(jax.vmap(jax_env.step))

    def run(state, action):
        with jax_boxbox_kernel():
            return step(state, action)

    return run


def _assert_vision(obs):
    for k in ("vision", "vision_goal"):
        v = obs[k]
        assert v.dtype == torch.uint8 and tuple(v.shape) == (B, 3, SIZE, SIZE, 3), k
        assert not bool(v.any()), k


def test_raycast_still_raises():
    """The raycast provider is ported (tests/test_torch_vision.py); on the
    dactyl-shaped world, which has no camera, the env refuses it by name."""
    with pytest.raises(ValueError, match="vision_cam_top"):
        t_locked.make_env({"vision_observation_provider": "raycast"}, device="cpu")


def test_reset_observations_and_cache_match_jax(port_env, jax_env, jax_reset):
    """The JAX reset state carried across (its cache a tree in goal_aux):
    every observation key of the port's `_observe` equal to the JAX
    env's, the images exactly; the port's own reset stages a cache of the
    JAX cache's RESET_GOAL entry (the goal images) with its shapes and
    dtypes, and no entry for the STEP provider, which `_observe` reads
    live."""
    keys, jstate, jobs = jax_reset
    tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
    inner, cache = tstate.goal_aux
    assert sorted(cache) == ["dummy_vision", "goal_dummy_vision"]
    tobs = port_env._observe(tstate)
    assert sorted(tobs) == sorted(jobs)
    for k in tobs:
        np.testing.assert_allclose(_np(tobs[k]).astype(np.float64),
                                   np.asarray(jobs[k], np.float64), rtol=0, atol=1e-6, err_msg=k)
    _assert_vision(tobs)
    attempts, draws = tenv.jax_reset_draws(keys, port_env.constants.max_pose_resets + 1)
    own, obs = port_env.reset(B, attempts, draws)
    own_inner, own_cache = own.goal_aux
    assert tuple(own_inner.shape) == tuple(inner.shape)
    jcache = jstate.goal_aux[1]
    assert sorted(own_cache) == ["goal_dummy_vision"]
    for name in own_cache:
        for k, v in jcache[name].items():
            got = own_cache[name][k]
            assert tuple(got.shape) == v.shape and _np(got).dtype == np.asarray(v).dtype
    _assert_vision(obs)


def _port_outputs(port_env, tstate, action, draws):
    def run(qvel):
        return port_env.step(tstate.replace(physics=tstate.physics.replace(qvel=qvel)), action,
                             draws=draws)

    return port_env.step(tstate, action, draws=draws), nudged_runs(run, tstate.physics.qvel)


def test_two_steps_match_jax(port_env, jax_env, jax_reset, jax_step):
    """Two steps from the JAX state carried across: every observation key
    (images exactly) and the cache, against the JAX env's."""
    _, jstate, _ = jax_reset
    rng = np.random.default_rng(7)
    for _ in range(2):
        action = rng.uniform(-1, 1, (B, 20)).astype(np.float32)
        tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
        tout, nudged = _port_outputs(port_env, tstate, tenv._t(action),
                                     tenv.jax_step_draws(jstate))
        jout = jax_step(jstate, jnp.asarray(action))
        tenv._compare_step(tout, jout, port_env.cube, nudged=nudged)
        assert sorted(tout[1]) == sorted(jout[1])
        for k in ("vision", "vision_goal"):
            np.testing.assert_array_equal(_np(tout[1][k]), np.asarray(jout[1][k]), err_msg=k)
        _assert_vision(tout[1])
        jstate = jout[0]


def test_forced_goal_resample_refreshes_resampled_envs_only(port_env, jax_env, jax_reset,
                                                           jax_step):
    """Envs 0 and 2 hold a success with no goal reset pending, so their
    goals resample this step: every output against the JAX step's, the
    goal images read again for those two envs only (the goal provider
    reads a state of two envs), and the other envs' rows kept; a step in
    which no env resamples carries the cached goal images over as the
    same tensor, uncopied."""
    _, jstate, _ = jax_reset
    pending = jnp.asarray([True, False, True, False])
    jstate = jstate.replace(tracker=jstate.tracker.replace(success_and_no_goal_reset=pending))
    action = np.zeros((B, 20), np.float32)
    jout = jax_step(jstate, jnp.asarray(action))
    assert (np.asarray(jout[0].tracker.goals_so_far) == 1 + np.asarray(pending)).all()
    tstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
    reads = []
    provider = port_env.obs_stack.providers["goal_dummy_vision"]

    def counting(env, state):
        reads.append(state.physics.qpos.shape[0])
        return provider.read(env, state)

    stack = port_env.obs_stack
    port_env.obs_stack = t_obs.ObservationStack(dict(
        stack.providers, goal_dummy_vision=dataclasses.replace(provider, read=counting)))
    try:
        tout, nudged = _port_outputs(port_env, tstate, tenv._t(action),
                                     tenv.jax_step_draws(jstate))
    finally:
        port_env.obs_stack = stack
    assert reads == [2] * 4           # the step and its three nudged runs
    tenv._compare_step(tout, jout, port_env.cube, nudged=nudged)
    for k in ("vision", "vision_goal"):
        np.testing.assert_array_equal(_np(tout[1][k]), np.asarray(jout[1][k]), err_msg=k)
    _assert_vision(tout[1])
    # no env resamples: the cache's goal images are the previous state's
    calm = tout[0].replace(tracker=tout[0].tracker.replace(
        success_and_no_goal_reset=torch.zeros(B, dtype=torch.bool)))
    after = port_env.step(calm, tenv._t(action))[0]
    assert torch.equal(after.tracker.goals_so_far, calm.tracker.goals_so_far)
    assert after.goal_aux[1]["goal_dummy_vision"]["vision_goal"] is \
        calm.goal_aux[1]["goal_dummy_vision"]["vision_goal"]
