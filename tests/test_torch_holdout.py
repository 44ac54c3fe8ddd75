"""The port's jsonnet evaluator, env loading and holdout env against the
JAX package's, on the CPU, on the stand-in holdout
(`robogym_torch/worlds/holdout_ball_like/`): a ball on a fixed 64-vert
platform and a cylinder standing on the table, B=3, `mujoco_substeps=2`.

The JAX env is loaded from the stand-in's jsonnet config by the JAX
package's own `load_env`, with its holdout module pointed, in this process
only, at the stand-in's object XMLs and saved states and its worlds at the
UR16e-shaped writer (`tools/build_locked_like_snapshot.holdout_stand_in`,
which also keys the JAX compiler's pair table in ascending type order, so
that the cylinder and the table collide: ROADMAP section 3, item 5). The
port's env is loaded by the port's `load_env` on the JAX env's compiled
models (`worlds=`) and starts from the JAX env's settled initial state.

Tolerances: both evaluators' outputs equal; the snapshot equal to a fresh
compile; the contact table of the first step's state as
`test_torch_collision.py` holds it; physics and obs as
`test_torch_mesh.py` holds them (the nudge rule over the whole batch,
both sims' start velocities nudged by 1e-6, and for a step the port's
float64 run); the goals, drawn from the saved goal states, exactly."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_collision import _compare_tables
from test_torch_mesh import (B, _np, _t, compare_state, compare_step, from_jax_start,
                             port_reset, port_step, port_worlds, snapshot_tool)
from test_torch_rearrange import _to_port
from test_torch_rearrange_family import _stack
from robogym_torch import bridge
from robogym_torch.envs.rearrange import holdout as t_holdout
from robogym_torch.mjcf.model import GeomType
from robogym_torch.physics.collision import driver as t_driver
from robogym_torch.utils import env_utils as t_env_utils
from robogym_torch.utils import jsonnet as t_jsonnet
from robogym_torch.worlds import holdout_ball_like
from robogym_tpu.utils import env_utils as j_env_utils
from robogym_tpu.utils import jsonnet as j_jsonnet

FAST = dict(constants=dict(mujoco_substeps=2))
ROUND = [("convex", GeomType.SPHERE, GeomType.MESH, 1), ("convex", GeomType.CYLINDER, GeomType.BOX, 1)]


# ---------------------------------------------------------------------------
# jsonnet and the config
# ---------------------------------------------------------------------------

SNIPPETS = [
    "local a = 2; { x:: a * 3, y: $.x + 1, z+: [1], [if a == 2 then 'w']: 'yes' } + { z+: [2] }",
    "{ a: { b: 1, c: self.b + 1 } + { b: 5 }, d: [x * 2 for x in [1, 2, 3]], "
    "e: if 3 > 2 then 'big' else 'small', f: std.length([1, 2]) + std.floor(2.7), "
    "g: '%s-%d' % ['x', 3], h: std.join(',', ['p', 'q']) }",
]


@pytest.mark.parametrize("src", SNIPPETS)
def test_jsonnet_snippets_match_jax(src):
    """The JAX test's semantics snippet (tests/test_holdout.py: hidden
    fields, late-bound `$`, `+:` merges, conditional fields) and one of
    object self-reference, comprehension, conditionals, std functions and
    `%`, each evaluated by both packages' evaluators."""
    assert t_jsonnet.evaluate_snippet(src) == j_jsonnet.evaluate_snippet(src)
    if src == SNIPPETS[0]:
        assert t_jsonnet.evaluate_snippet(src) == {"y": 7, "z": [1, 2], "w": "yes"}


def test_stand_in_config_matches_jax():
    """The stand-in config by both evaluators, and the factory each
    package's `get_function` resolves from it: the port's holdout
    `make_env` with the config's args bound."""
    got = t_jsonnet.evaluate_file(holdout_ball_like.CONFIG)
    assert got == j_jsonnet.evaluate_file(holdout_ball_like.CONFIG)
    sim = got["make_env"]["args"]["parameters"]["simulation_params"]
    assert [c["xml_path"] for c in sim["task_object_configs"]] == ["ball.xml", "cylinder.xml"]
    fn = t_env_utils.get_function(got["make_env"])
    assert fn.func is t_holdout.make_env
    assert fn.keywords == got["make_env"]["args"]
    assert j_env_utils.get_function(got["make_env"]).func.__module__ == \
        "robogym_tpu.envs.rearrange.holdout"


def test_stand_in_files_and_world_match_their_writers(tmp_path):
    """The committed platform STL and saved states are what
    `holdout_ball_like.write_files` writes, and `holdout_ball_like.npz` what
    the snapshot tool compiles now: 2 free objects (nv = 24), the scene
    body, and the round-geom groups (sphere-mesh, cylinder-box,
    cylinder-mesh, sphere-cylinder) among its pairs."""
    holdout_ball_like.write_files(str(tmp_path))
    with open(holdout_ball_like.PLATFORM_STL) as a, open(tmp_path / "holdout_platform.stl") as b:
        assert a.read() == b.read()
    for name in sorted(os.listdir(holdout_ball_like.STATE_DIR)):
        with np.load(os.path.join(holdout_ball_like.STATE_DIR, name)) as a, \
                np.load(tmp_path / "states" / name) as b:
            assert sorted(a.files) == sorted(b.files) == ["obj_pos", "obj_quat"], name
            assert all(np.array_equal(a[k], b[k]) for k in a.files), name
    _, fresh = snapshot_tool().compile_snapshot("holdout_ball_like")
    with np.load(holdout_ball_like.SNAPSHOT) as z:
        assert sorted(fresh) == sorted(z.files)
        for k in z.files:
            assert np.array_equal(fresh[k], z[k]), k
    m = bridge.model_from_numpy(fresh, "cpu")
    assert m.const.nv == 24 and "scene0_0" in m.const.names["body"]
    keys = {(g["kind"], int(g["t1"]), int(g["t2"]), g["ncon"])
            for g in t_driver.build_groups(m.const, m.opt.group_cap)}
    assert set(ROUND) <= keys
    assert ("convex", GeomType.CYLINDER, GeomType.MESH, 1) in keys
    assert ("convex", GeomType.SPHERE, GeomType.CYLINDER, 1) in keys


# ---------------------------------------------------------------------------
# the env
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_env(tmp_path_factory):
    with snapshot_tool().holdout_stand_in(str(tmp_path_factory.mktemp("holdout"))):
        return j_env_utils.load_env(holdout_ball_like.CONFIG, **FAST)


@pytest.fixture(scope="module")
def port_env(jax_env):
    env = t_env_utils.load_env(holdout_ball_like.CONFIG, device="cpu",
                               worlds=port_worlds(jax_env), **FAST)
    return from_jax_start(env, jax_env)


def _pool(jenv, key):
    return {"pool": jax.random.randint(key, (), 0, jenv.goal_gen.pool_pos.shape[0])}


def jax_reset_draws(jenv, keys):
    """The port's `reset` draws from the JAX reset keys (blocks.py:384-438,
    holdout.py:181-212): the placement and settle before the teleport, the
    first goal's pool index and the one drawn after the teleport from the
    key folded with 11; the holdout draws no model field."""
    per, O = [], jenv.max_num_objects
    for key in keys:
        k_place, k_rot, _, k_goal, k_pause, _, _ = jax.random.split(key, 7)
        per.append(dict(
            place_u=np.stack([np.asarray(jax.random.uniform(k, (20, 2), jnp.float32))
                              for k in jax.random.split(k_place, O)]),
            place_rot_u=np.asarray([jax.random.uniform(k, ()) for k in jax.random.split(k_rot, O)]),
            goal=_pool(jenv, k_goal), pause_u=jax.random.uniform(k_pause, ()),
            initial_goal=_pool(jenv, jax.random.fold_in(key, 11)),
            lam_u=np.float32(0.5), gumbel=np.zeros((O, O), np.float32),
            color_u=np.zeros((O, 3), np.float32)))
    return _stack(per)


def jax_step_draws(jenv, jstate):
    per = []
    for key in np.asarray(jstate.key):
        _, k_goal, k_pause = jax.random.split(jnp.asarray(key), 3)
        per.append(dict(goal=_pool(jenv, k_goal), pause_u=jax.random.uniform(k_pause, ())))
    return _stack(per)


@pytest.fixture(scope="module")
def run(port_env, jax_env):
    """The JAX reset of seed 2 and the port's on its draws; then three
    steps, each from the JAX state, actions uniform in [-1, 1]."""
    keys = jax.random.split(jax.random.PRNGKey(2), B)
    jstate, jobs = jax.jit(jax.vmap(jax_env.reset))(keys)
    out = [(port_reset(port_env, jax_reset_draws(jax_env, keys)), (jstate, jobs))]
    step = jax.jit(jax.vmap(jax_env.step))
    rng = np.random.default_rng(2)
    for _ in range(3):
        action = rng.uniform(-1, 1, (B, port_env.action_size)).astype(np.float32)
        tout = port_step(port_env, _to_port(jstate), _t(action), jax_step_draws(jax_env, jstate))
        jout = step(jstate, jnp.asarray(action))
        out.append((tout, jout))
        jstate = jout[0]
    return out


def test_reset_matches_jax(run, port_env, jax_env):
    """The reset: the objects at the saved initial state (exactly), the
    goal from the saved goal state, the rest of the state by the nudge
    rule."""
    ((tstate, tobs), nudged), (jstate, jobs) = run[0]
    compare_state(tstate, tobs, jstate, jobs, port_env, nudged, settled=False)
    init = port_env._initial_state["obj_pos"]
    np.testing.assert_allclose(_np(tobs["obj_pos"]), np.broadcast_to(init, (B,) + init.shape),
                               rtol=0, atol=1e-6)
    np.testing.assert_array_equal(_np(tstate.goal["obj_pos"]),
                                  np.broadcast_to(np.asarray(jax_env.goal_gen.pool_pos[0]),
                                                  (B,) + init.shape))


def test_contact_table_matches_jax(run, port_env, jax_env):
    """The contact table of the first step's JAX state (the ball pressed
    into the platform, the cylinder into the table; at the reset they only
    touch, and which exact-zero depths count as live is float noise) by
    both packages' `fwd_position`, as `test_torch_collision.py` holds it:
    the round-geom groups' live pairs among it."""
    from robogym_torch.physics import step as t_step
    from robogym_tpu.physics import step as j_step

    jd = run[1][1][0].physics
    want = jax.jit(jax.vmap(lambda x: j_step.fwd_position(jax_env.model, x)))(jd)
    got = t_step.fwd_position(port_env.model, bridge.data_from_numpy(bridge.data_to_numpy(jd),
                                                                     "cpu"))
    _compare_tables(port_env.model, want, got)


@pytest.mark.parametrize("i", [1, 2, 3])
def test_steps_match_jax(run, port_env, i):
    """Each of the three steps from the JAX state, by the nudge rule; the
    ball on the platform and the cylinder on the table keep their round-geom
    groups live in every env."""
    (tout, nudged), jout = run[i]
    compare_step(tout, jout, port_env, nudged, settled=False)
    d = tout[0].physics
    base = 0
    for g in t_driver.build_groups(port_env.model.const, port_env.model.opt.group_cap):
        n = g["K"] * g["ncon"]
        if (g["kind"], int(g["t1"]), int(g["t2"]), g["ncon"]) in ROUND:
            assert _np(d.contact.active[:, base:base + n]).any(-1).all(), g["t1"]
        base += n
