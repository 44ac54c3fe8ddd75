"""The port's reach env and the hand's effort control against the JAX
package's, on the CPU, on the reach stand-in world
(`robogym_torch/worlds/dactyl_reach_like.py`, nv = 24).

The JAX env runs at float32 under `jax.vmap`, built on the stand-in by
pointing `reach.build_reach_xml`, in this process only, at the world's
XML. Random draws are made from the JAX keys (the same splits as the JAX
functions make) and fed to the port's env, so both packages run the same
episode; states cross by `bridge.env_state_to_numpy` /
`env_state_from_numpy`.

Tolerances: functions off the physics to 1e-5 (effort control, goal
distances); one substep to 1e-4 (test_torch_step.py's substep tolerance);
env runs (the construction's settle, the goal sims, env steps) by the
nudge rule of `_torch_common.assert_physics_close` over the hand's joints,
and the fingertip positions they give to the envelope's qpos tolerance in
metres.

The fingers' hulls are octagonal prisms, and where two of them touch the
hull sweep's bf16 direction pick meets near-ties: from the same inputs
the port's plain hull functions and the JAX package's (its XLA reference,
the CPU default) can pick other directions, with depths up to 0.34 mm
apart in this file's steps, and the JAX package's own reference gives
other answers to the same inputs inside its jitted env step than alone
(ROADMAP section 3, item 6). `test_hull_ties_are_valid_witnesses` shows
that both packages' answers are valid: each separation is the hulls' own
along its normal, its points are supports of both hulls, and its depth
lies within the sweep's bound (SWEEP_BOUND) of an exact separating-axis
depth, never shallower where the hulls overlap. So the env runs keep the
JAX package's own hulls, and the nudge rule takes both packages' nudged
runs (`jax_nudged`, `assert_physics_close`'s `ref_nudged`): an env on
such a tie moves under a 1e-6 m/s nudge in the JAX env as in the port,
and is held to NUDGE_RATIO times the larger package's drift."""

import copy
import dataclasses
import functools
import typing

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (QPOS_TOL, QVEL_TOL, assert_physics_close, jax_data_from_numpy,
                           nudged_runs)
from robogym_torch import bridge
from robogym_torch.envs import core as t_core
from robogym_torch.envs.dactyl import reach as t_reach
from robogym_torch.envs.rearrange import goals as t_goals
from robogym_torch.goal import goal_generator as t_goal
from robogym_torch.mjcf.model import make_data
from robogym_torch.physics import step as t_step
from robogym_torch.physics.collision import convex_kernel as t_ck
from robogym_torch.robot import shadow_hand as t_hand
from robogym_torch.worlds import dactyl_reach_like
from robogym_tpu.envs import core as j_core
from robogym_tpu.envs.dactyl import reach as j_reach
from robogym_tpu.goal import goal_generator as j_goal
from robogym_tpu.physics import step as j_step
from robogym_tpu.robot import shadow_hand as j_hand

B = 4
FN_TOL = 1e-5       # functions off the physics
SUBSTEP_TOL = 1e-4  # one substep
# A hull witness's separation and support points, against the hulls' own
# along its normal: the sweep picks support verts by bf16 dots of verts
# centred on each hull (relative rounding 2^-8), so a pick may be off by
# twice that of each hull's radius r (m): WITNESS_REL * (r1 + r2).
WITNESS_REL = 2 * 2.0 ** -8
# A sweep's depth against the exact separating-axis depth: its last ring
# searches 0.08 (rad, in the tangent plane) around its best direction, so
# its normal may miss the exact axis by that angle, and its depth by
# SWEEP_BOUND * (r1 + r2) (m), always on the deep side.
SWEEP_BOUND = 0.08


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.asarray(x))


@functools.lru_cache(maxsize=None)
def _jax_hull_fn(manifold, DX):
    """The JAX package's local-vert hull core under `jax.vmap` (its XLA
    reference, the CPU default), batched as the port's plain versions take
    their operands."""
    from robogym_tpu.physics.collision import convex_kernel as j_ck

    core = (j_ck._make_hull_manifold_core_loc if manifold else j_ck._make_hull_core_loc)(DX)
    dirs12, ring = jnp.asarray(j_ck._dirs12_np()), jnp.asarray(j_ck._ring_np())
    fn = jax.jit(jax.vmap(core, in_axes=(0,) * 9 + (None, None)))
    return lambda *arrays: fn(*[jnp.asarray(_np(a)) for a in arrays], dirs12, ring)


def jax_hulls(manifold, arrays, DX):
    """The JAX package's answer to a hull call of the port: torch tensors."""
    return tuple(torch.as_tensor(np.array(o)) for o in _jax_hull_fn(manifold, DX)(*arrays))


def jax_nudged(jstep, jstate, action, nudges=3):
    """The JAX env's own `jstep` from `jstate` with its qvel nudged as
    `nudged_runs` nudges the port's (the same draws), one vmapped call for
    the runs: a `data_to_numpy` dict a run."""
    qvel = torch.as_tensor(np.array(jstate.physics.qvel))
    qvels = nudged_runs(lambda q: q, qvel, nudges)
    tiled = jax.tree_util.tree_map(lambda x: jnp.concatenate([x] * nudges), jstate)
    tiled = tiled.replace(physics=tiled.physics.replace(
        qvel=jnp.asarray(np.concatenate([_np(q) for q in qvels]))))
    out = bridge.data_to_numpy(jstep(tiled, jnp.concatenate([jnp.asarray(action)] * nudges))[0]
                               .physics)
    return [{k: v[i * B:(i + 1) * B] for k, v in out.items()} for i in range(nudges)]


@pytest.fixture(scope="module")
def port_built():
    return t_reach.make_env(device="cpu", seed=0)


@pytest.fixture(scope="module")
def port_env(port_built, jax_env):
    """The port's env with the JAX env's settled start, so that both
    packages' resets and goal sims start from one state (the settle itself
    is held by `test_settle_matches_jax`)."""
    env = copy.copy(port_built)
    env._initial_data = bridge.data_from_numpy(
        {k: v[None] for k, v in bridge.data_to_numpy(jax_env._initial_data).items()}, "cpu")
    return env


@pytest.fixture(scope="module")
def jax_env(tmp_path_factory):
    """The JAX ReachEnv on the stand-in world: `build_reach_xml` returns
    the world's XML while the env is built."""
    xml = dactyl_reach_like.write(str(tmp_path_factory.mktemp("reach")))
    orig = j_reach.build_reach_xml
    j_reach.build_reach_xml = lambda: xml
    try:
        return j_reach.ReachEnv(j_reach.ReachEnvConstants(), dtype=jnp.float32)
    finally:
        j_reach.build_reach_xml = orig


def _with(env, **kw):
    """A copy of an env (either package's) with other constants."""
    out = copy.copy(env)
    out.constants = dataclasses.replace(env.constants, **kw)
    return out


def _draws(k_goal, k_pause):
    return dict(goal_noise=np.asarray(jax.random.normal(k_goal, (24,), jnp.float32)),
                pause_u=np.float32(jax.random.uniform(k_pause, ())))


def _stack(ds):
    return {k: _t(np.stack([d[k] for d in ds])) for k in ds[0]}


def reset_draws(keys):
    """The port's reset draws from the JAX reset keys."""
    out = []
    for key in keys:
        k_goal, k_pause, _ = jax.random.split(key, 3)
        out.append(_draws(k_goal, k_pause))
    return _stack(out)


def step_draws(state):
    """The port's step draws from the JAX state's keys."""
    out = []
    for key in np.asarray(state.key):
        _, k_goal, k_pause = jax.random.split(jnp.asarray(key), 3)
        out.append(_draws(k_goal, k_pause))
    return _stack(out)


def jax_env_state(arrays, keys, model_fields=None):
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
                           key=jnp.asarray(keys), t=jnp.asarray(arrays["t"]),
                           model_fields=model_fields)


def to_port(jstate):
    return bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")


@pytest.fixture(scope="module")
def jax_reset(jax_env):
    """The JAX env reset at B from seeded keys: (keys, state, obs)."""
    keys = jax.random.split(jax.random.PRNGKey(21), B)
    state, obs = jax.jit(jax.vmap(jax_env.reset))(keys)
    return keys, state, obs


# ---------------------------------------------------------------------------
# the world, the goal protocol, effort control
# ---------------------------------------------------------------------------

def test_hand_index_binds_and_goal_types(port_env, jax_env):
    for f in dataclasses.fields(t_hand.HandIndex):
        np.testing.assert_array_equal(np.asarray(getattr(port_env.hand, f.name)),
                                      np.asarray(getattr(jax_env.hand, f.name)))
    c = port_env.model.const
    assert (c.nq, c.nv, c.nu) == (24, 24, 20)
    assert bool(c.actuator_forcelimited.all())
    assert t_goal.goal_types() == j_goal.goal_types() == {"generic"}
    # the port's goal generators meet the protocol, as the JAX package's do
    # (tests/test_blocks_env.py::test_goal_generators_satisfy_protocol)
    proto = typing.runtime_checkable(t_goal.GoalGenerator)
    for cls in (t_goals.ObjectStateGoal, t_goals.TrainStateGoal, t_goals.ObjectReachGoal,
                t_goals.DeterministicReachGoal, t_goals.ObjectStackGoal,
                t_goals.PickAndPlaceGoal, t_goals.ObjectFixedStateGoal, t_goals.DominoStateGoal):
        assert issubclass(cls, proto), cls
    assert dataclasses.asdict(t_reach.ReachEnvConstants()).items() <= \
        dataclasses.asdict(j_reach.ReachEnvConstants()).items()


def test_effort_control_functions_match_jax(port_env, jax_env, jax_reset):
    """`effort_control_model` (its const a new object: the position
    model's caches stay behind), `set_effort_control` and
    `actuator_effort` on the reset states and seeded commands, to 1e-5."""
    _, state, _ = jax_reset
    tm, jm = port_env.model, jax_env.model
    t_hand.HandIndex.build(tm)
    t_step.step(tm, make_data(tm, 1))      # fills the position model's const caches
    te = t_hand.effort_control_model(port_env.hand, tm)
    je = j_hand.effort_control_model(jax_env.hand, jm)
    assert te.const is not tm.const and "_actuation_partition" not in te.const.__dict__
    for name in ("actuator_gaintype", "actuator_biastype"):
        np.testing.assert_array_equal(getattr(te.const, name), getattr(je.const, name))
    for name in ("actuator_gainprm", "actuator_biasprm", "actuator_ctrlrange"):
        np.testing.assert_array_equal(_np(getattr(te, name)), np.asarray(getattr(je, name)))
    np.testing.assert_array_equal(_np(tm.actuator_gainprm), np.asarray(jm.actuator_gainprm))
    d = bridge.data_from_numpy(bridge.data_to_numpy(state.physics), "cpu")
    cmd = np.random.default_rng(3).uniform(-1, 1, (B, 20)).astype(np.float32)
    got = t_hand.set_effort_control(port_env.hand, te, d, _t(cmd))
    want = jax.vmap(lambda x, c: j_hand.set_effort_control(jax_env.hand, je, x, c))(
        state.physics, jnp.asarray(cmd))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=FN_TOL)
    np.testing.assert_allclose(
        _np(t_hand.actuator_effort(port_env.hand, tm, d)),
        np.asarray(jax.vmap(lambda x: j_hand.actuator_effort(jax_env.hand, jm, x))(state.physics)),
        rtol=0, atol=FN_TOL)


def clipped_effort(cmd, em, hand):
    """(applied force, `actuator_effort`) that a command `cmd` (B, 20) in
    [-1, 1] gives under the effort model `em` of `hand`: the command
    denormalized by the force limits, then clamped to the control range
    [-1, 1] before the force limit, as both packages' actuation does
    (ROADMAP section 3, item 5): a limit above 1 (the wrist's, THJ4's,
    THJ3's) clips a command above 1 / limit."""
    ids = torch.as_tensor(hand.actuator_ids)
    limits = em.actuator_forcerange[ids]
    cr = em.actuator_ctrlrange[ids]
    force = torch.clamp(t_hand.denormalize_by_limit(cmd, limits), cr[:, 0], cr[:, 1])
    force = torch.clamp(force, limits[:, 0], limits[:, 1])
    return force, t_hand.normalize_by_limits(force, limits)


def test_one_effort_substep_matches_jax(port_env, jax_env, jax_reset):
    """One substep under the effort model from the reset states: the
    applied force is the command denormalized by the force limits and
    clamped to the control range, and `actuator_effort` gives that back,
    to 1e-5 (`clipped_effort`; the commands clip on some actuators and
    not on others); the state after the substep against the JAX step to
    1e-4."""
    _, state, _ = jax_reset
    te = t_hand.effort_control_model(port_env.hand, port_env.model)
    je = j_hand.effort_control_model(jax_env.hand, jax_env.model)
    d = bridge.data_from_numpy(bridge.data_to_numpy(state.physics), "cpu")
    cmd = _t(np.random.default_rng(4).uniform(-1, 1, (B, 20)).astype(np.float32))
    d = d.replace(ctrl=t_hand.set_effort_control(port_env.hand, te, d, cmd))
    got = t_step.step(te, d)
    ids = torch.as_tensor(port_env.hand.actuator_ids)
    force, effort = clipped_effort(cmd, te, port_env.hand)
    clipped = (force != t_hand.denormalize_by_limit(cmd, te.actuator_forcerange[ids])).any(0)
    assert 0 < int(clipped.sum()) < 20, clipped
    np.testing.assert_allclose(_np(got.actuator_force[:, ids]), _np(force), rtol=0, atol=FN_TOL)
    np.testing.assert_allclose(_np(t_hand.actuator_effort(port_env.hand, te, got)), _np(effort),
                               rtol=0, atol=FN_TOL)
    jd = jax.jit(jax.vmap(lambda x: j_step.step(je, x)))(
        jax_data_from_numpy(bridge.data_to_numpy(d)))
    td, jd = bridge.data_to_numpy(got), bridge.data_to_numpy(jd)
    for k in ("qpos", "qvel", "actuator_force"):
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=SUBSTEP_TOL, err_msg=k)


def test_effort_roundtrip_on_a_fresh_state(port_env):
    """The JAX test's check (tests/test_parity_extras.py): from qpos0, a
    command from -1 to 1 comes back from `actuator_effort` after a step,
    where its force is within the control range; clipped to it
    (`clipped_effort`) where it is not."""
    te = t_hand.effort_control_model(port_env.hand, port_env.model)
    d = make_data(te, 1)
    cmd = torch.linspace(-1.0, 1.0, 20)[None]
    d = t_step.step(te, d.replace(ctrl=t_hand.set_effort_control(port_env.hand, te, d, cmd)))
    _, effort = clipped_effort(cmd, te, port_env.hand)
    np.testing.assert_allclose(_np(t_hand.actuator_effort(port_env.hand, te, d)), _np(effort),
                               rtol=0, atol=FN_TOL)


# ---------------------------------------------------------------------------
# hull ties
# ---------------------------------------------------------------------------

def sat_separation(v1, v2):
    """The exact signed separation of two convex hulls (3, V) in float64
    where they overlap (< 0: minus the penetration depth): the least
    overlap over the separating axes, every face normal of either hull and
    every cross product of an edge of one with an edge of the other (the
    triangulated faces' diagonals add axes, none of them below the exact).
    Where the hulls are apart, a lower bound of their distance."""
    from scipy.spatial import ConvexHull

    hulls = [ConvexHull(v.T) for v in (v1, v2)]
    edges = []
    for h, v in zip(hulls, (v1, v2)):
        ends = {tuple(sorted((t[i], t[(i + 1) % 3]))) for t in h.simplices for i in range(3)}
        edges.append(np.asarray([v[:, b] - v[:, a] for a, b in ends]))
    cross = np.cross(edges[0][:, None], edges[1][None]).reshape(-1, 3)
    norm = np.linalg.norm(cross, axis=-1)
    cross = cross[norm > 1e-12] / norm[norm > 1e-12, None]
    axes = np.concatenate([hulls[0].equations[:, :3], hulls[1].equations[:, :3], cross, -cross])
    return -((axes @ v1).max(-1) - (axes @ v2).min(-1)).min()


def assert_valid_witness(v1, v2, c1, c2, n, dist=None, p1=None, p2=None, corners=()):
    """One pair's answer from a hull sweep (float64 world verts (3, V)):
    the hulls' separation along the unit normal `n` lies within
    SWEEP_BOUND * (r1 + r2) under the exact one (`sat_separation`), and,
    where the hulls overlap, not above it; the answer's `dist` is that
    separation, `p1` and `p2` are supports of hull 1 along n and of hull 2
    along -n, and each manifold corner (the first three slots: the fourth
    may be the pair's fallback point) is a vert of hull 1 whose depth is
    its distance from hull 2's support plane, each within WITNESS_REL *
    (r1 + r2). Returns (the separation along n, the exact one)."""
    r = (np.linalg.norm(v1 - c1[:, None], axis=0).max()
         + np.linalg.norm(v2 - c2[:, None], axis=0).max())
    tol = WITNESS_REL * r
    d1, d2 = n @ v1, n @ v2
    sep = d2.min() - d1.max()
    exact = sat_separation(v1, v2)
    assert abs(np.linalg.norm(n) - 1.0) <= 1e-5, n
    assert sep >= exact - SWEEP_BOUND * r, (sep, exact, r)
    assert exact > 0 or sep <= exact + tol, (sep, exact)
    if dist is not None:
        assert abs(dist - sep) <= tol, (dist, sep, tol)
        assert n @ p1 >= d1.max() - tol and n @ p2 <= d2.min() + tol, (n @ p1, n @ p2)
    for corner, depth in corners:
        assert np.linalg.norm(v1 - corner[:, None], axis=0).min() <= tol, corner
        assert abs(depth - (d2.min() - n @ corner)) <= tol, (depth, d2.min() - n @ corner)
    return sep, exact


def test_hull_ties_are_valid_witnesses(port_env, jax_reset):
    """Every hull call of the port's three steps of
    `test_three_steps_match_jax` (the same start and actions) goes to both
    packages' hull functions on the same inputs. Where their answers part
    (normals more than 1e-5 apart: a tie of the bf16 direction pick), both
    are valid witnesses (`assert_valid_witness`). The reach world's
    touching fingers meet such ties: some of the pairs overlap."""
    _, jstate, _ = jax_reset
    calls = []

    def recording(manifold, fn):
        def rec(*args):
            calls.append((manifold, args[:-1], args[-1]))
            return fn(*args)
        return rec

    orig = (t_ck.hull_pair_plain, t_ck.hull_manifold_plain)
    t_ck.hull_pair_plain = recording(False, orig[0])
    t_ck.hull_manifold_plain = recording(True, orig[1])
    try:
        state, rng = to_port(jstate), np.random.default_rng(7)
        for _ in range(3):
            action = rng.uniform(-1.2, 1.2, (B, 20)).astype(np.float32)
            state = port_env.step(state, _t(action), draws=step_draws(jstate))[0]
    finally:
        t_ck.hull_pair_plain, t_ck.hull_manifold_plain = orig
    ties, overlapping = 0, 0
    for manifold, arrays, DX in calls:
        got = [_np(x).astype(np.float64) for x in orig[manifold](*arrays, DX)]
        want = [_np(x).astype(np.float64) for x in jax_hulls(manifold, arrays, DX)]
        v1 = _np(t_ck.world_from_loc(*arrays[:3])).astype(np.float64)
        v2 = _np(t_ck.world_from_loc(*arrays[3:6])).astype(np.float64)
        c1, c2 = (_np(a).astype(np.float64) for a in arrays[6:8])
        part = np.abs(got[2] - want[2]).max(-1) > 1e-5                       # (B, K)
        for b, k in zip(*np.nonzero(part)):
            for out in (got, want):
                if manifold:
                    dist4, pos4, n = out[0][b, k], out[1][b, k], out[2][b, k]
                    live = dist4 < 1e9
                    corners = [(pos4[i] + 0.5 * dist4[i] * n, dist4[i]) for i in range(3)
                               if live[i]]
                    _, exact = assert_valid_witness(v1[b, k], v2[b, k], c1[b, k], c2[b, k],
                                                    n, corners=corners)
                else:
                    dist, pos, n, p2 = (x[b, k] for x in out)
                    _, exact = assert_valid_witness(v1[b, k], v2[b, k], c1[b, k], c2[b, k],
                                                    n, dist, 2.0 * pos - p2, p2)
            ties += 1
            overlapping += exact < 0
    assert ties and overlapping, (ties, overlapping)


# ---------------------------------------------------------------------------
# the reach env
# ---------------------------------------------------------------------------

def test_settle_matches_jax(port_built, jax_env):
    """The construction's settle (20 env steps of centred control, 200
    substeps, one env), against the JAX env's `_initial_data`."""
    td = bridge.data_to_numpy(port_built._initial_data)
    jd = {k: v[None] for k, v in bridge.data_to_numpy(jax_env._initial_data).items()}
    assert_physics_close(td, jd, None)
    np.testing.assert_array_equal(td["time"], [0.0])


def _goal_runs(env, gjp, noise, nudges=3):
    """`_next_goal` of the port's env, then its runs with the settled
    start's qvel nudged: (goal sim's hand qpos as states, nudged states)."""
    base = env._initial_data

    def run(qvel):
        env._initial_data = base.replace(qvel=qvel)
        try:
            goal, new = env._next_goal(noise, gjp)
        finally:
            env._initial_data = base
        return {"qpos": _np(new), "qvel": np.zeros_like(_np(new)), "tips": _np(goal["fingertip_pos"])}

    return run(base.qvel), nudged_runs(run, base.qvel, nudges)


def _assert_goal_close(got, want_goal, want_gjp, nudged):
    """The goal sim's joint positions by the nudge rule (qpos group), its
    fingertip goals to the same envelope in metres, on the calm envs."""
    jd = {"qpos": np.asarray(want_gjp), "qvel": np.zeros_like(np.asarray(want_gjp))}
    chaotic = assert_physics_close(got, jd, None, nudged)
    np.testing.assert_allclose(got["tips"][~chaotic],
                               np.asarray(want_goal["fingertip_pos"])[~chaotic],
                               rtol=0, atol=QPOS_TOL)


def test_reset_matches_jax(port_env, jax_env, jax_reset):
    """Reset on the draws of the JAX keys, from the JAX env's settled
    start: the start (its fwd_position) to 1e-5, the goal sim's goals by
    the nudge rule, the tracker exactly."""
    keys, jstate, jobs = jax_reset
    draws = reset_draws(keys)
    state, obs = port_env.reset(B, draws=draws)
    for k in ("qpos", "qvel", "fingertip_pos"):
        np.testing.assert_allclose(_np(obs[k]), np.asarray(jobs[k]), rtol=0, atol=FN_TOL,
                                   err_msg=k)
    np.testing.assert_array_equal(_np(state.tracker.success_steps_required),
                                  np.asarray(jstate.tracker.success_steps_required))
    gjp0 = t_hand.joint_positions(port_env.hand, state.physics)
    got, nudged = _goal_runs(port_env, gjp0, draws["goal_noise"])
    _assert_goal_close(got, jstate.goal, jstate.goal_aux, nudged)
    np.testing.assert_allclose(_np(state.goal_aux), got["qpos"], rtol=0, atol=0)
    np.testing.assert_allclose(
        _np(state.prev_goal_distance["fingertip_pos"]),
        np.linalg.norm(got["tips"] - _np(obs["fingertip_pos"]), axis=-1), rtol=1e-6, atol=1e-7)
    assert port_env.goal_sims >= 1


def _compare_step(tout, jout, nudged, jax_runs):
    """The port's step outputs against the JAX package's: physics by the
    nudge rule with both packages' nudged runs (the port's `nudged`, the
    JAX env's `jax_runs`); on the calm envs obs, rewards and distances
    within the envelope's tolerances; tracker, done and the info's
    integers exactly."""
    (ts, tobs, trew, tdone, tinfo), (js, jobs, jrew, jdone, jinfo) = tout, jout
    calm = ~assert_physics_close(bridge.data_to_numpy(ts.physics),
                                  bridge.data_to_numpy(js.physics), None,
                                  [bridge.data_to_numpy(n[0].physics) for n in nudged],
                                  ref_nudged=jax_runs)
    for k in tobs:
        tol = {"qvel": QVEL_TOL}.get(k, QPOS_TOL)
        np.testing.assert_allclose(_np(tobs[k])[calm], np.asarray(jobs[k])[calm], rtol=0,
                                   atol=tol, err_msg=k)
    np.testing.assert_allclose(_np(trew)[calm], np.asarray(jrew)[calm], rtol=0, atol=QPOS_TOL)
    np.testing.assert_array_equal(_np(tdone), np.asarray(jdone))
    for f in dataclasses.fields(t_core.TrackerState):
        np.testing.assert_array_equal(_np(getattr(ts.tracker, f.name)),
                                      np.asarray(getattr(js.tracker, f.name)), err_msg=f.name)
    for k, v in tinfo.items():
        if v.dtype in (torch.bool, torch.int32):
            np.testing.assert_array_equal(_np(v), np.asarray(jinfo[k]), err_msg=k)
    return calm


def _port_step(env, state, action, draws, nudges=3):
    """The port's step, and its steps from the state's qvel nudged."""
    out = env.step(state, action, draws=draws)

    def run(qvel):
        return env.step(state.replace(physics=state.physics.replace(qvel=qvel)), action,
                        draws=draws)

    return out, nudged_runs(run, state.physics.qvel, nudges)


def test_three_steps_match_jax(port_env, jax_env, jax_reset):
    """Three steps, each from the JAX state carried across, with seeded
    actions in [-1.2, 1.2] (clipped by both)."""
    _, jstate, _ = jax_reset
    jstep = jax.jit(jax.vmap(jax_env.step))
    rng = np.random.default_rng(7)
    for _ in range(3):
        action = rng.uniform(-1.2, 1.2, (B, 20)).astype(np.float32)
        tout, nudged = _port_step(port_env, to_port(jstate), _t(action), step_draws(jstate))
        jout = jstep(jstate, jnp.asarray(action))
        _compare_step(tout, jout, nudged, jax_nudged(jstep, jstate, action))
        jstate = jout[0]


@pytest.mark.parametrize("stabilize", [2, 0])
def test_forced_goal_resample_matches_jax(port_env, jax_env, jax_reset, stabilize):
    """Envs 0 and 2 hold a success with no goal reset pending, so their
    goals resample this step (the others keep theirs): the goal sim runs
    on those two envs only, `goal_stabilize_steps` x 10 substeps under a
    relative zero action (2) or its forward kinematics (0). Goals and goal
    joint positions by the nudge rule against the JAX step's; the kept
    goals exactly."""
    _, jstate, _ = jax_reset
    penv, jenv = (_with(e, goal_stabilize_steps=stabilize) for e in (port_env, jax_env))
    pending = jnp.asarray([True, False, True, False])
    jstate = jstate.replace(tracker=jstate.tracker.replace(success_and_no_goal_reset=pending))
    action = jnp.zeros((B, 20), jnp.float32)
    jstep = jax.jit(jax.vmap(jenv.step))
    jout = jstep(jstate, action)
    draws = step_draws(jstate)
    state = to_port(jstate)
    sims, n_envs = penv.goal_sims, penv.goal_sim_envs
    tout, nudged = _port_step(penv, state, _t(np.zeros((B, 20), np.float32)), draws)
    # the step and its three nudged runs
    assert (penv.goal_sims - sims, penv.goal_sim_envs - n_envs) == (4, 8)
    _compare_step(tout, jout, nudged, jax_nudged(jstep, jstate, action))
    ts, js = tout[0], jout[0]
    kept = ~np.asarray(pending)
    np.testing.assert_array_equal(_np(ts.goal["fingertip_pos"])[kept],
                                  _np(state.goal["fingertip_pos"])[kept])
    np.testing.assert_array_equal(_np(ts.goal_aux)[kept], _np(state.goal_aux)[kept])
    assert not np.array_equal(_np(ts.goal["fingertip_pos"])[~kept],
                              _np(state.goal["fingertip_pos"])[~kept])
    envs = torch.as_tensor(np.flatnonzero(~kept))
    got, nud = _goal_runs(penv, state.goal_aux[envs], draws["goal_noise"][envs])
    np.testing.assert_array_equal(_np(ts.goal_aux)[~kept], got["qpos"])
    _assert_goal_close(got, {"fingertip_pos": np.asarray(js.goal["fingertip_pos"])[~kept]},
                       np.asarray(js.goal_aux)[~kept], nud)
    np.testing.assert_array_equal(_np(ts.tracker.consecutive_successes)[~kept], 0)


def seeded_fields(tm, seed=0):
    """Each env's own dof_damping, actuator kp (gainprm[:, 0]), jnt_margin
    and gravity, seeded with numpy."""
    rng = np.random.default_rng(seed)
    damping = tm.dof_damping.numpy() * rng.uniform(0.5, 2.0, (B, tm.const.nv))
    gp = np.broadcast_to(tm.actuator_gainprm.numpy(), (B,) + tuple(tm.actuator_gainprm.shape))
    gp = gp.copy()
    gp[..., 0] *= rng.uniform(0.75, 1.5, (B, tm.const.nu))
    margin = rng.uniform(0.0, 0.05, (B, tm.const.njnt))
    gravity = tm.opt.gravity.numpy() + 0.4 * rng.standard_normal((B, 3))
    return {"dof_damping": damping, "actuator_gainprm": gp, "jnt_margin": margin,
            "opt:gravity": gravity}


def test_step_with_model_fields_matches_jax(port_env, jax_env, jax_reset):
    """Two steps with each env's own model fields in `state.model_fields`,
    which `step` lays over the model (the goal sim keeps the compiled
    model, as the JAX env's does)."""
    keys, jstate, _ = jax_reset
    fields = {k: np.asarray(v, np.float32) for k, v in seeded_fields(port_env.model).items()}
    jstate = jstate.replace(model_fields={k: jnp.asarray(v) for k, v in fields.items()})
    jstep = jax.jit(jax.vmap(jax_env.step))
    rng = np.random.default_rng(8)
    for _ in range(2):
        action = rng.uniform(-1, 1, (B, 20)).astype(np.float32)
        state = to_port(jstate)
        assert sorted(state.model_fields) == sorted(fields)
        tout, nudged = _port_step(port_env, state, _t(action), step_draws(jstate))
        jout = jstep(jstate, jnp.asarray(action))
        _compare_step(tout, jout, nudged, jax_nudged(jstep, jstate, action))
        jstate = jout[0]
    # the fields matter: without them the same step moves otherwise
    bare = port_env.step(to_port(jstate).replace(model_fields=None), _t(action))[0]
    with_f = port_env.step(to_port(jstate), _t(action))[0]
    assert np.abs(_np(bare.physics.qvel) - _np(with_f.physics.qvel)).max() > QVEL_TOL


def test_make_env_defaults_to_the_card():
    import inspect

    assert inspect.signature(t_reach.make_env).parameters["device"].default == "cuda"
