"""The port's wrapper layer (`robogym_torch/wrappers/`) against the JAX
package's, on the CPU at B=4, in float32 on both sides.

Each transform runs on a stub env that both packages' transforms bind to
(the dactyl-shaped world's model, its hand and cube index tables and the
locked env's constants, no physics step), as tests/test_wrappers.py's
`fake` fixture gives the JAX transforms an env: init, the per-episode
model randomization, then three rounds of action, per-step model fields,
per-step physics, reward, observation and done on seeded inputs. The JAX
side runs each hook under `jax.vmap` with a key per env; the port's hook
gets the samples that the JAX transform draws from those keys (the same
`jax.random` call on the same split key, `DRAWS`). Floats are held to
1e-6 abs plus 1e-6 relative; integers, booleans and discrete actions
exactly.

The whole default stack, `apply_dactyl_wrappers(make_env(), randomize=True)`,
runs on the dactyl-shaped world (the JAX LockedEnv built on it as
tests/test_torch_env.py builds it): the port's `wrap_reset` on the JAX
env's own reset state and the JAX draws gives the JAX wrapped reset's
observations, transform states and model fields (those to 1e-6 relative);
then three steps with the same discrete actions and the JAX draws, each
from the JAX state carried across by the bridge: the timestep field every
step (1e-6 relative), dones and the transform states' integers and
booleans exactly, the physics by `_torch_common.assert_physics_close`
under its nudge rule, and on the other envs observations, rewards and the
transform states' floats within the tolerances that the env-step envelope
gives them (test_torch_env.py)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (CUBE_POS_TOL, QPOS_TOL, QVEL_TOL, assert_physics_close,
                           jax_boxbox_kernel, nudged_runs, snapshot_arrays,
                           snapshot_jax_model, snapshot_model, to_jax)
from robogym_torch import bridge
from robogym_torch import wrappers as TW
from robogym_torch.envs.dactyl import cube_env as t_cube
from robogym_torch.envs.dactyl import locked as t_locked
from robogym_torch.mjcf.model import make_data
from robogym_torch.physics import step as t_step
from robogym_torch.robot import shadow_hand as t_hand
from robogym_torch.worlds import dactyl_locked_like
from robogym_torch.wrappers.core import model_field
from robogym_tpu import wrappers as JW
from robogym_tpu.envs.dactyl import cube_env as j_cube
from robogym_tpu.envs.dactyl import locked as j_locked
from robogym_tpu.robot import shadow_hand as j_hand
from robogym_tpu.wrappers import dactyl as j_dactyl
from robogym_tpu.wrappers import randomizations as j_rand

B = 4
ANGLE_TOL = 4 * QPOS_TOL   # test_torch_env.py's
NBODY, NTENDON = (int(snapshot_arrays(dactyl_locked_like.SNAPSHOT)["const." + k])
                  for k in ("nbody", "ntendon"))
split = jax.random.split


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# Each draw is the JAX transform's own call: in float32 where it names its
# dtype, else in JAX's default float (float64 under the test suite's x64
# setting; the port gets the samples in float32, as its generator makes
# them).
def _u(k, shape=(), dtype=jnp.float32):
    return np.asarray(jax.random.uniform(k, shape, dtype))


def _n(k, shape=(), dtype=jnp.float32):
    return np.asarray(jax.random.normal(k, shape, dtype))


def _e(k, shape=()):
    return np.asarray(jax.random.exponential(k, shape))


def _ud(k, shape=()):
    return np.asarray(jax.random.uniform(k, shape))


def _nd(k, shape=()):
    return np.asarray(jax.random.normal(k, shape))


# ---------------------------------------------------------------------------
# the samples each JAX transform draws from its key, per env: hook -> fn(t,
# key, tstate, obs) -> the port's draws for one env (numpy); `tstate` and
# `obs` are that env's JAX transform state and observation before the hook
# ---------------------------------------------------------------------------

def _obs_noise(t, key, ts, obs):
    out = {}
    lv = sorted(t.levels)
    n = {k: 1 if k.endswith("_quat") else obs[k].shape[-1] for k in lv}
    if "additive" not in ts:
        bkey, add, mul = ts["key"], {}, {}
        for k in lv:
            bkey, k1, k2 = split(bkey, 3)
            add[k], mul[k] = _n(k1, (n[k],)), _n(k2, (n[k],))
        out.update(additive=add, multiplicative=mul)
    unc, axis = {}, {}
    for k in lv:
        key, k1, k2 = split(key, 3)
        unc[k] = _n(k1, (n[k],))
        if k.endswith("_quat"):
            axis[k] = _u(k2, (3,))
    return dict(out, uncorrelated=unc, axis=axis)


def _obs_delay(t, key, ts, obs):
    delay = {}
    for g in sorted(t.groups):
        key, k = split(key)
        delay[g] = _nd(k)
    return {"delay": delay}


def _two(k, shape, first, second):
    k1, k2 = split(k)
    return first(k1, shape), second(k2, shape)


DRAWS = [
    (j_rand.RandomizedBodyInertiaWrapper,
     {"model": lambda t, k, ts, o: {"u": _u(k, (NBODY, 1))}}),
    (j_rand.RandomizedFrictionBaseWrapper,
     {"model": lambda t, k, ts, o: {"u": np.stack([_u(kk) for kk in split(k, 3)])}}),
    (j_rand.RandomizedGravityWrapper, {"model": lambda t, k, ts, o: {"n": _n(k, (3,))}}),
    (j_rand.RandomizedWindWrapper, {"model": lambda t, k, ts, o: {"n": _n(k, (3,))}}),
    (j_rand.RandomizedTimestepWrapper, {
        "init": lambda t, k, ts, o: dict(zip(
            ("pos_lambda", "neg_lambda", "side", "p_flip_pos", "p_flip_neg"),
            [f(kk) for f, kk in zip((_u, _u, _ud, _ud, _ud), split(k, 5))])),
        "model_step": lambda t, k, ts, o: dict(zip(("flip_u", "exp"), _two(k, (), _ud, _e)))}),
    (j_rand.RandomizedDampingWrapper,
     {"model": lambda t, k, ts, o: {"u": _u(k, (len(t.dof_ids),))}}),
    (j_rand.RandomizedKpWrapper,
     {"model": lambda t, k, ts, o: {"u": _u(k, (len(t.actuator_ids),))}}),
    (j_rand.RandomizedJointLimitWrapper,
     {"model": lambda t, k, ts, o: {"n": _n(k, (len(t.joint_ids), 2))}}),
    (j_rand.RandomizedTendonRangeWrapper,
     {"model": lambda t, k, ts, o: {"n": _n(k, (NTENDON, 2))}}),
    (j_rand.RandomizeObservationWrapper, {"observation": _obs_noise}),
    (j_rand.ObservationDelayWrapper, {"observation": _obs_delay}),
    (j_rand.FreezingPhasespaceMarkers, {"observation": lambda t, k, ts, o: dict(zip(
        ("start_u", "exp"), _two(k, (o[t.key].shape[-1] // 3,), _ud, _e)))}),
    (j_dactyl.FreezingPhasespaceBody, {"observation": lambda t, k, ts, o: dict(zip(
        ("start_u", "exp"), _two(k, (), _ud, _e))) if any(x in o for x in t.keys) else None}),
    (j_rand.ActionNoiseWrapper, {
        "init": lambda t, k, ts, o: dict(zip(("mult", "add"), _two(k, (20,), _n, _n))),
        "action": lambda t, k, ts, o: {"noise": _n(k, (20,))}}),
    (j_rand.RandomizedActionLatency, {"init": lambda t, k, ts, o: {
        "delay": np.asarray(jax.random.randint(k, (20,), 0, t.max_delay + 1))}}),
    (j_rand.RandomizedBrokenActuatorWrapper, {
        "init": lambda t, k, ts, o: {"u": _ud(k, (20,))},
        "action": lambda t, k, ts, o: {"u": _u(k, (20,))}}),
    (j_rand.BacklashWrapper,
     {"init": lambda t, k, ts, o: dict(zip(("down", "up"), _two(k, (20,), _n, _n)))}),
    (j_rand.ActionDelayWrapper, {"init": lambda t, k, ts, o: {"n": _n(k)},
                                 "action": lambda t, k, ts, o: {"n": _n(k)}}),
    (j_dactyl.RandomizedCubeSizeWrapper, {"model": lambda t, k, ts, o: {"u": _u(k)}}),
    (j_dactyl.RandomizedWindWrapper, {
        "init": lambda t, k, ts, o: {"u": _u(k)},
        "physics": lambda t, k, ts, o: dict(zip(("hit_u", "n"), (_ud(split(k)[0]),
                                                                  _n(split(k)[1], (3,)))))}),
    (j_dactyl.RandomizedPhasespaceFingersWrapper,
     {"model": lambda t, k, ts, o: {"n": _n(k, (len(t.site_ids), 3))}}),
]
def _stack(items):
    """Per-env draws (dicts of numpy, nested) stacked into tensors, floats
    in float32."""
    if items[0] is None:
        return None
    if isinstance(items[0], dict):
        return {k: _stack([x[k] for x in items]) for k in items[0]}
    a = np.stack(items)
    return torch.as_tensor(a.astype(np.float32) if a.dtype.kind == "f" else a)


def _env_tree(tree, i):
    return jax.tree_util.tree_map(lambda x: x[i], tree)


def jax_draws(t, hook, keys, tstate=None, obs=None):
    """The port's draws for JAX transform `t`'s `hook` from the per-env
    `keys`, given the JAX transform state and observation before it."""
    for cls, table in DRAWS:
        if isinstance(t, cls):
            fn = table.get(hook)
            if fn is None:
                return None
            per = [fn(t, keys[i], _env_tree(tstate, i) if tstate is not None else None,
                      _env_tree(obs, i) if obs is not None else None) for i in range(len(keys))]
            return _stack(per)
    return None


def assert_tree_close(got, want, path="", atol=1e-6, rtol=1e-6):
    """The port's tree against the JAX one: the same structure (the JAX
    dicts may hold more keys: a PRNG key the port does not keep), floats
    within tolerance (by default 1e-6 abs, and 1e-6 relative where a value
    is far above 1: float32 keeps 7 digits, and the timestep transform's
    rates are in the thousands), integers and booleans exactly."""
    if want is None:
        assert got is None, path
        return
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) <= set(want), (path, sorted(got), sorted(want))
        assert set(want) - set(got) <= {"key"}, (path, sorted(got), sorted(want))
        for k in got:
            assert_tree_close(got[k], want[k], f"{path}.{k}", atol, rtol)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_tree_close(g, w, f"{path}[{i}]", atol, rtol)
        return
    g, w = _np(got), np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if w.dtype.kind == "f":
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=path)
    else:
        np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=path)


# ---------------------------------------------------------------------------
# per-transform tests on a stub env
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stubs():
    """(JAX stub env, port stub env, JAX states, port states): the
    dactyl-shaped world's model, index tables and the locked env's
    constants; B states settled for 5 substeps by the port."""
    path = dactyl_locked_like.SNAPSHOT
    jm, tm = snapshot_jax_model(path), snapshot_model(path)
    jenv = types.SimpleNamespace(model=jm, hand=j_hand.HandIndex.build(jm),
                                 cube=j_cube.CubeIndex.build(jm),
                                 constants=j_locked.LockedEnvConstants(), action_size=20,
                                 dtype=jnp.float32)
    penv = types.SimpleNamespace(model=tm, hand=t_hand.HandIndex.build(tm),
                                 cube=t_cube.CubeIndex.build(tm),
                                 constants=t_locked.LockedEnvConstants(), action_size=20,
                                 dtype=torch.float32, device=torch.device("cpu"),
                                 generator=torch.Generator().manual_seed(0))
    qpos, ctrl = dactyl_locked_like.initial_state(snapshot_arrays(path), B, 0)
    d = make_data(tm, B, torch.as_tensor(qpos)).replace(ctrl=torch.as_tensor(ctrl))
    d = t_step.step_n(tm, d, 5)
    xf = np.random.default_rng(1).standard_normal(tuple(d.xfrc_applied.shape)).astype(np.float32)
    d = d.replace(xfrc_applied=torch.as_tensor(xf))
    return jenv, penv, to_jax(d), d


def _unit(rng, *shape):
    q = rng.standard_normal(shape + (4,)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _obs(rng):
    """Seeded observations with the locked env's keys (and the noisy keys
    the stack's inner transforms add), some past ClipObservation's 100."""
    f = np.float32
    return {
        "cube_pos": rng.normal(0.3, 0.05, (B, 3)).astype(f), "cube_quat": _unit(rng, B),
        "hand_angle": rng.uniform(-1.5, 1.5, (B, 24)).astype(f),
        "fingertip_pos": rng.normal(0.0, 0.05, (B, 15)).astype(f),
        "goal_pos": np.zeros((B, 3), f), "goal_quat": _unit(rng, B),
        "qvel": rng.uniform(-300.0, 300.0, (B, 36)).astype(f),
        "noisy_cube_pos": rng.normal(0.3, 0.05, (B, 3)).astype(f),
        "noisy_cube_quat": _unit(rng, B),
        "noisy_relative_goal_pos": rng.normal(0.0, 0.05, (B, 3)).astype(f),
        "noisy_relative_goal_quat": _unit(rng, B),
    }


FREEZE = dict(disappear_p_1s=0.99, freeze_scale_s=0.05)
DELAY_LEVELS = {"interpolators": {"cube_quat": "QuatInterpolator",
                                  "hand_angle": "RadianInterpolator"},
                "groups": {"a": {"obs_names": ["cube_pos", "cube_quat"], "mean": 1.5, "std": 1.0},
                           "b": {"obs_names": ["hand_angle"], "mean": 0.5, "std": 2.0}}}
CASES = [
    ("DiscretizeActionWrapper", {}), ("DiscretizeActionWrapper", {"bin_spacing": "exponential"}),
    ("ClipActionWrapper", {}), ("ClipObservationWrapper", {}), ("ClipRewardWrapper", {}),
    ("SummedRewardsWrapper", {}), ("SmoothActionWrapper", {}),
    ("SmoothActionWrapper", {"alpha": 0.3}), ("PreviousActionObservationWrapper", {}),
    ("RelativeGoalWrapper", {"obs_prefix": "cube_"}),
    ("UnifiedGoalObservationWrapper", {"goal_parts": ["pos", "quat"]}),
    ("RewardObservationWrapper", {"reward_inds": [1, 2]}), ("RewardObservationWrapper", {}),
    ("RewardNameWrapper", {}),
    ("RandomizedBodyInertiaWrapper", {}), ("RandomizedFrictionWrapper", {}),
    ("RandomizedRobotFrictionWrapper", {}), ("RandomizedCubeFrictionWrapper", {}),
    ("RandomizedGravityWrapper", {}), ("RandomizedTimestepWrapper", {}),
    ("RandomizedOptWindWrapper", {}), ("RandomizedDampingWrapper", {}),
    ("RandomizedRobotDampingWrapper", {}), ("RandomizedKpWrapper", {}),
    ("RandomizedRobotKpWrapper", {}), ("RandomizedJointLimitWrapper", {}),
    ("RandomizedTendonRangeWrapper", {}),
    ("RandomizeObservationWrapper", {"levels": TW.LOCKED_NOISE_LEVELS}),
    ("ObservationDelayWrapper", {"levels": DELAY_LEVELS}),
    ("FreezingPhasespaceMarkers", FREEZE), ("ActionNoiseWrapper", {}),
    ("RandomizedActionLatency", {}), ("RandomizedActionLatency", {"max_delay": 2}),
    ("RandomizedBrokenActuatorWrapper", {"proba_broken": 0.3}), ("BacklashWrapper", {}),
    ("ActionDelayWrapper", {}),
    ("FixedWristWrapper", {"wrj0_pos": 0.1}), ("StopOnFallWrapper", {}),
    ("StopOnFallWrapper", {"min_episode_length": 2}), ("AngleObservationWrapper", {}),
    ("RandomizedCubeSizeWrapper", {}), ("RandomizedWindWrapper", {}),
    ("RandomizedPhasespaceFingersWrapper", {}), ("FingersFreezingPhasespaceMarkers", FREEZE),
    ("FreezingPhasespaceBody", dict(FREEZE, keys=["cube_pos", "noisy_cube_quat", "absent"])),
    ("CubeFreezingPhasespaceBody", FREEZE), ("FingersOccludedPhasespaceMarkers", {}),
    ("FingerSeparationWrapper", {}), ("FingerSeparationWrapper", {"active_finger": "RF"}),
]


def _fields_of(model, names):
    return {f: model_field(model, f) for f in names}


@pytest.mark.parametrize("name,kwargs", CASES, ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_transform_matches_jax(stubs, name, kwargs):
    jenv, penv, jd, pd = stubs
    tj, tp = getattr(JW, name)(env=jenv, **kwargs), getattr(TW, name)(env=penv, **kwargs)
    assert tuple(tj.model_fields) == tuple(tp.model_fields)
    assert tj.has_physics_hook == tp.has_physics_hook
    rng = np.random.default_rng(abs(hash(name)) % 1000)
    key = iter(split(jax.random.PRNGKey(7), 64))

    def keys():
        return split(next(key), B)

    def env_state(d):
        return types.SimpleNamespace(physics=d)

    k = keys()
    jts = jax.vmap(lambda kk: tj.init(kk, jenv))(k)
    pts = tp.init(jax_draws(tj, "init", k), penv, B)
    assert_tree_close(pts, jts, "init")

    mf_j = mf_p = None
    if tj.model_fields:
        k = keys()
        mf_j = jax.vmap(lambda ts, kk: _fields_of(tj.model(ts, jenv.model, kk), tj.model_fields))(
            jts, k)
        base = {f: model_field(penv.model, f).expand((B,) + tuple(model_field(penv.model, f).shape))
                .clone() for f in tp.model_fields}
        mf_p = tp.model(pts, base, jax_draws(tj, "model", k))
        assert_tree_close(mf_p, mf_j, "model")

    for step in range(3):
        if name == "DiscretizeActionWrapper":
            a = rng.integers(-1, 13, (B, 20)).astype(np.int32)
        else:
            a = rng.uniform(-1.5, 1.5, (B, 20)).astype(np.float32)
        k = keys()
        jts, ja = jax.vmap(lambda ts, aa, kk, d: tj.action(ts, aa, kk, jenv, env_state(d)))(
            jts, jnp.asarray(a), k, jd)
        pts, pa = tp.action(pts, torch.as_tensor(a), jax_draws(tj, "action", k), penv,
                            env_state(pd))
        assert_tree_close((pts, pa), (jts, ja), f"action {step}")

        if tj.model_fields:
            k = keys()
            jts, mf_j = jax.vmap(lambda ts, mf, kk: tj.model_step(ts, mf, kk, jenv))(jts, mf_j, k)
            pts, mf_p = tp.model_step(pts, mf_p, jax_draws(tj, "model_step", k), penv)
            assert_tree_close((pts, mf_p), (jts, mf_j), f"model_step {step}")
        if tj.has_physics_hook:
            k = keys()
            jts, jd = jax.vmap(lambda ts, d, kk: tj.physics(ts, d, kk, jenv))(jts, jd, k)
            pts, pd = tp.physics(pts, pd, jax_draws(tj, "physics", k), penv)
            assert_tree_close((pts, pd.xfrc_applied), (jts, jd.xfrc_applied), f"physics {step}")

        r = rng.uniform(-150.0, 150.0, (B, 3)).astype(np.float32)
        jts, jr = jax.vmap(tj.reward)(jts, jnp.asarray(r))
        pts, pr = tp.reward(pts, torch.as_tensor(r))
        assert_tree_close((pts, pr), (jts, jr), f"reward {step}")

        obs = _obs(rng)
        k = keys()
        jo = {kk: jnp.asarray(v) for kk, v in obs.items()}
        draws = jax_draws(tj, "observation", k, jts, jo)
        jts, jobs = jax.vmap(lambda ts, o, kk, d: tj.observation(ts, o, kk, jenv, env_state(d)))(
            jts, jo, k, jd)
        pts, pobs = tp.observation(pts, {kk: torch.as_tensor(v) for kk, v in obs.items()}, draws,
                                   penv, env_state(pd))
        assert sorted(pobs) == sorted(jobs)
        assert_tree_close((pts, pobs), (jts, jobs), f"observation {step}")

        dn = rng.random(B) < 0.3
        jts, jdn = jax.vmap(lambda ts, x, d: tj.done(ts, x, jenv, env_state(d)))(
            jts, jnp.asarray(dn), jd)
        pts, pdn = tp.done(pts, torch.as_tensor(dn), penv, env_state(pd))
        assert_tree_close((pts, pdn), (jts, jdn), f"done {step}")


def test_default_stack_lists_match_jax():
    """The default stack's entries, and its 30 transforms' names."""
    for kw in ({}, {"randomize": False}, {"fixed_wrist": True, "relative_goal_wrapper": False}):
        assert (TW.construct_default_dactyl_wrappers(**kw)
                == JW.construct_default_dactyl_wrappers(**kw))
    assert len(TW.construct_default_dactyl_wrappers()) == 30
    wl = [["A"], ["B", {"x": 1}], ["C"]]
    edits = dict(insert_above=[("B", ["Z"])], insert_below=[("A", ["Y"])],
                 replace=[("C", ["W"])], delete=["A"])
    assert TW.edit_wrappers(wl, **edits) == JW.edit_wrappers(wl, **edits)


# ---------------------------------------------------------------------------
# the whole default stack on the dactyl-shaped world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def envs(tmp_path_factory):
    """(JAX wrapped LockedEnv on the stand-in world, the port's on the
    CPU)."""
    xml = dactyl_locked_like.write(str(tmp_path_factory.mktemp("dactyl")))
    orig = j_cube.build_cube_world_xml
    j_cube.build_cube_world_xml = lambda *a, **kw: xml
    try:
        with jax_boxbox_kernel():
            jenv = j_locked.LockedEnv(j_locked.LockedEnvConstants(), dtype=jnp.float32)
    finally:
        j_cube.build_cube_world_xml = orig
    penv = t_locked.make_env(device="cpu", seed=0)
    return JW.apply_dactyl_wrappers(jenv, randomize=True), TW.apply_dactyl_wrappers(
        penv, randomize=True)


def _key_splits(keys, n):
    """(B, n) keys: each env's key split n ways."""
    return jnp.stack([split(k, n) for k in keys])


def _hook_draws(jw, hook, keys):
    """A `draws` entry for `hook`: transform i's draws from keys[:, i],
    given the transform state and observation that reach it (the port's:
    the draw functions read only their keys' presence and shapes, and the
    JAX transform state's PRNG key where the port state carries it)."""
    def fn(i, tstate=None, obs=None):
        return jax_draws(jw.transforms[i], hook, keys[:, i], tstate, obs)

    return fn


def _goal_draws(key):
    """The port's `LockedEnv.step` draws from one env's JAX step key."""
    _, k_goal, k_pause = split(key, 3)
    kz, kp = split(k_goal)
    return dict(goal_u=np.float32(jax.random.uniform(kz, (), jnp.float32)),
                goal_choice=np.int64(jax.random.randint(kp, (), 0, 24)),
                pause_u=np.float32(jax.random.uniform(k_pause, ())))


def obs_tol(k):
    """The tolerance of an observation key within the env-step envelope
    (test_torch_env.py's `_compare_step`); the action-derived keys hold
    no physics."""
    if k in ("previous_action", "action_history", "action_delay", "action_ema", "fell_down"):
        return 1e-6
    if "qvel" in k:
        return QVEL_TOL
    if "fingertip" in k:
        return 2e-3
    if k.endswith("cube_pos") or k.endswith("goal_pos"):
        return CUBE_POS_TOL
    return 2 * ANGLE_TOL


@pytest.fixture(scope="module")
def jax_wrapped_reset(envs):
    """The JAX wrapped reset at B from seeded keys, and the inner env's
    reset (its first split key): (keys, state, obs, inner state, inner
    obs)."""
    jw, _ = envs
    keys = split(jax.random.PRNGKey(11), B)
    with jax_boxbox_kernel():
        state, obs = jax.jit(jax.vmap(jw.reset))(keys)
        inner, inner_obs = jax.jit(jax.vmap(jw.env.reset))(
            jnp.stack([split(k, 4)[0] for k in keys]))
    return keys, state, obs, inner, inner_obs


def test_wrapped_reset_matches_jax(envs, jax_wrapped_reset):
    """`wrap_reset` on the JAX env's own reset state with the JAX draws:
    observations and transform states to 1e-6 abs, model fields to 1e-6
    relative. Of the twelve fields the stack overrides, the
    dactyl-shaped world leaves two equal across envs in both packages (it
    has no cube:top or cube:bottom body to move, and its tendons no range
    to widen), and the timestep stays the compiled one until the first
    step."""
    jw, pw = envs
    keys, jstate, jobs, inner, inner_obs = jax_wrapped_reset
    n = len(jw.transforms)
    k4 = _key_splits(keys, 4)
    ki, km, ko = (_key_splits(k4[:, j], n) for j in (1, 2, 3))
    obs_fn = _hook_draws(jw, "observation", ko)

    def observation_draws(i, tstate, obs):
        # the JAX noise transform draws its biases from its init key
        if isinstance(jw.transforms[i], j_rand.RandomizeObservationWrapper):
            tstate = {"key": ki[:, i]}
        return obs_fn(i, tstate, obs)

    draws = {"init": _hook_draws(jw, "init", ki), "model": _hook_draws(jw, "model", km),
             "observation": observation_draws}
    pstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(inner), "cpu")
    pobs = {k: torch.as_tensor(np.asarray(v)) for k, v in inner_obs.items()}
    got_state, got_obs = pw.wrap_reset(pstate, pobs, draws)
    assert sorted(got_obs) == sorted(jobs)
    assert_tree_close(got_obs, dict(jobs), "obs")
    assert_tree_close(got_state.goal_aux[1], jstate.goal_aux[1], "tstates")
    assert sorted(got_state.model_fields) == sorted(jstate.model_fields)
    assert len(got_state.model_fields) == 12
    assert_tree_close(got_state.model_fields, jstate.model_fields, "model_fields", atol=1e-12,
                      rtol=1e-6)
    for k, v in got_state.model_fields.items():
        same = bool((v == v[:1]).all())
        assert same == (k in ("body_pos", "tendon_range", "opt:timestep")), k
        if same:
            assert torch.equal(v[0], model_field(pw.env.model, k)), k


def _calm_tree_close(got, want, calm, path):
    """Transform states (B, ...): integers and booleans exactly, floats on
    the `calm` envs within the env-step envelope's 2 * ANGLE_TOL."""
    if isinstance(want, dict):
        for k in got:
            _calm_tree_close(got[k], want[k], calm, f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            _calm_tree_close(g, w, calm, f"{path}[{i}]")
    elif want is not None:
        g, w = _np(got), np.asarray(want)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g[calm], w[calm], rtol=0, atol=2 * ANGLE_TOL, err_msg=path)
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=path)


def test_wrapped_steps_match_jax(envs, jax_wrapped_reset):
    """Three steps of the whole stack, each from the JAX state carried
    across by the bridge (transform states and model fields with it), with
    the same discrete actions and the JAX draws. The nudge rule is a rule
    of one step from one state: env 0 of this batch sits on a
    discontinuity, where start qvels nudged by 1e-6 drift by 5e-3 in one
    step, so the two packages' states part further every step they run
    apart."""
    jw, pw = envs
    _, jstate, _, _, _ = jax_wrapped_reset
    jstep = jax.jit(jax.vmap(jw.step))
    rng = np.random.default_rng(5)
    n = len(jw.transforms)
    for step in range(3):
        pstate = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
        action = rng.integers(0, 11, (B, 20)).astype(np.int32)
        key, k_act, k_obs = (_key_splits(np.asarray(jstate.key), 3)[:, j] for j in range(3))
        draws = {
            "action": _hook_draws(jw, "action", _key_splits(k_act, n)),
            "model_step": _hook_draws(jw, "model_step", _key_splits(
                jnp.stack([jax.random.fold_in(k, 1) for k in key]), n)),
            "physics": _hook_draws(jw, "physics", _key_splits(
                jnp.stack([jax.random.fold_in(k, 2) for k in key]), n)),
            "observation": _hook_draws(jw, "observation", _key_splits(k_obs, n)),
            "env": _stack([_goal_draws(k) for k in key]),
        }
        with jax_boxbox_kernel():
            jout = jstep(jstate, jnp.asarray(action))

        def run(qvel):
            st = pstate.replace(physics=pstate.physics.replace(qvel=qvel))
            return pw.step(st, torch.as_tensor(action), draws)

        tout = pw.step(pstate, torch.as_tensor(action), draws)
        calm = ~assert_physics_close(bridge.data_to_numpy(tout[0].physics),
                                     bridge.data_to_numpy(jout[0].physics), pw.env.cube,
                                     [bridge.data_to_numpy(x[0].physics)
                                      for x in nudged_runs(run, pstate.physics.qvel)])
        np.testing.assert_allclose(_np(tout[0].model_fields["opt:timestep"]),
                                   np.asarray(jout[0].model_fields["opt:timestep"]), rtol=1e-6)
        np.testing.assert_array_equal(_np(tout[3]), np.asarray(jout[3]))
        assert sorted(tout[1]) == sorted(jout[1])
        for k in tout[1]:
            np.testing.assert_allclose(_np(tout[1][k])[calm], np.asarray(jout[1][k])[calm],
                                       rtol=0, atol=obs_tol(k), err_msg=f"{k} at step {step}")
        np.testing.assert_allclose(_np(tout[2])[calm], np.asarray(jout[2])[calm], rtol=0,
                                   atol=2 * ANGLE_TOL)
        _calm_tree_close(tout[0].goal_aux[1], jout[0].goal_aux[1], calm, f"tstates {step}")
        jstate = jout[0]


def test_bridge_carries_wrapped_state(envs):
    """The port's wrapped state through `env_state_to_numpy` and back:
    model fields, the inner goal_aux and every transform state (dicts,
    tuples, None and tensors of every dtype), equal."""
    _, pw = envs
    state, _ = pw.reset(2)
    state, *_ = pw.step(state, torch.zeros((2, 20), dtype=torch.int64))
    back = bridge.env_state_from_numpy(bridge.env_state_to_numpy(state), "cpu")
    assert sorted(back.model_fields) == sorted(state.model_fields)
    for k, v in state.model_fields.items():
        assert torch.equal(back.model_fields[k], v), k

    def same(a, b, path):
        assert type(a) is type(b) or (isinstance(a, tuple) and isinstance(b, tuple)), path
        if isinstance(a, dict):
            assert sorted(a) == sorted(b), path
            for k in a:
                same(a[k], b[k], f"{path}.{k}")
        elif isinstance(a, tuple):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{path}[{i}]")
        elif a is not None:
            assert a.dtype == b.dtype and torch.equal(a, b), path

    same(back.goal_aux, state.goal_aux, "goal_aux")
