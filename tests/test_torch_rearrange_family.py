"""The port's blocks family (blocks_train, dominos, reach, det-reach, stack,
pick-and-place, attached, duplicate, wordblocks) against the JAX
package's, on the CPU, at a small size: 3 object slots, B=3,
`stabilize_steps=1`, the default control (TCP through the mocap_ik dual
sim).

The JAX envs are built on the UR16e-shaped stand-in
(`robogym_torch/worlds/rearrange_blocks_like.py`) by pointing
`simulation.build_blocks_world_xml`, in this process only, at the world's
writer, as `tests/test_torch_rearrange.py` does; their box-box pairs run
through the Pallas kernel in interpret mode. Two JAX envs are built:
blocks_train with every option this slice ports (`use_cuboid` at scales
exp-uniform in +-0.2, `pickup_proba` and `stacking_proba` 0.3,
`stabilize_goal` on the objects-only settle world the JAX env compiles,
`mask_obs_outside_placement_area` with the soft mask), and dominos under
`is_holdout` on its own world. The other envs run on copies of the
blocks_train env with their constants, parameters, goal generator and
class swapped in as their JAX `make_env`s set them (the JAX attached,
dominos and wordblocks `make_env`s swap goal generators the same way). The
port's envs are built by their own `make_env`s on the JAX envs' compiled
models (`worlds=`), and reset from the JAX env's settled initial state.
Draws come from the JAX keys as in `tests/test_torch_rearrange.py` (the
goal classes' from `tests/test_torch_rearrange_goals.py`); states cross by
`bridge.env_state_to_numpy` / `env_state_from_numpy`.

Tolerances: the model fields of the cuboids 1e-6 relative; goals drawn
without a settle 1e-6 abs, their integer and boolean fields exactly;
physics by the env-step envelope of `_torch_common.assert_physics_close`
(objects 2e-4 m, qpos 1e-3, qvel 5e-2) under its nudge rule over the whole
batch (both sims' start velocities nudged by 1e-6, and for a step also
the port's run in float64 from the same state: the fingers' four-bars,
closed by connect equalities, move further under float32 rounding than
under a 1e-6 nudge: in the det-reach step's env 1 the port's float32
run ends 1.28e-3 rad from its float64 run and a nudge moves it 2.9e-4;
over 16 envs of that step both packages' float32 runs end as far from the
port's float64 run, 2.98e-4 and 2.86e-4 on average); a settled goal's
poses
the same way, each object's position against the objects' envelope and its
pose against qpos', the nudged runs nudging the settle world's start
velocities too; on the envs within every envelope the obs within
`test_torch_rearrange._obs_tol` (euler angles of quaternions twice its
qpos tolerance: an angle moves by up to twice a quaternion component), the
goals' placement masks exactly;
rewards, done, the tracker and the info's integers and booleans exactly."""

import contextlib
import copy
import dataclasses
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (NUDGE, QPOS_TOL, _env_err, _groups, assert_physics_close,
                           jax_boxbox_kernel)
from test_torch_rearrange import _objects, _obs_tol, _port_model, _to_port, _within_envelope
from test_torch_rearrange_goals import (_attached_draws, _det_reach_draws, _domino_draws,
                                        _pickandplace_draws, _stack_draws, _state_draws,
                                        _train_draws)
from robogym_torch import bridge
from robogym_torch.envs import core as t_core
from robogym_torch.envs.rearrange import blocks as t_blocks
from robogym_torch.envs.rearrange import blocks_attached as t_attached
from robogym_torch.envs.rearrange import blocks_duplicate as t_duplicate
from robogym_torch.envs.rearrange import blocks_pickandplace as t_pickandplace
from robogym_torch.envs.rearrange import blocks_reach as t_reach
from robogym_torch.envs.rearrange import blocks_stack as t_stack
from robogym_torch.envs.rearrange import blocks_train as t_train
from robogym_torch.envs.rearrange import dominos as t_dominos
from robogym_torch.envs.rearrange import goals as t_goals
from robogym_torch.envs.rearrange import wordblocks as t_word
from robogym_torch.worlds import rearrange_blocks_like
from robogym_tpu.envs.rearrange import blocks as j_blocks
from robogym_tpu.envs.rearrange import blocks_attached as j_attached
from robogym_tpu.envs.rearrange import blocks_duplicate as j_duplicate
from robogym_tpu.envs.rearrange import blocks_train as j_train
from robogym_tpu.envs.rearrange import dominos as j_dominos
from robogym_tpu.envs.rearrange import goals as j_goals
from robogym_tpu.envs.rearrange import simulation as j_sim
from robogym_tpu.envs.rearrange import wordblocks as j_word
from robogym_tpu.mjcf.xml_tools import MjcfXML
from robogym_tpu.robot import composite as j_comp
from robogym_tpu.utils import rotation as j_rot

B = 3
O = 3
TRAIN_CONSTANTS = {"stabilize_steps": 1, "use_cuboid": True,
                   "mask_obs_outside_placement_area": True,
                   "goal_args": {"pickup_proba": 0.3, "stacking_proba": 0.3,
                                 "stabilize_goal": True, "soft_mask": True}}
TRAIN_PARAMETERS = {"simulation_params": {"num_objects": 2, "max_num_objects": O},
                    "object_scale_low": 0.2, "object_scale_high": 0.2}
# the goal classes' draws from their key (by the JAX class's name)
GOAL_DRAWS = {"ObjectStateGoal": _state_draws, "TrainStateGoal": _train_draws,
              "ObjectReachGoal": _state_draws, "DeterministicReachGoal": _det_reach_draws,
              "ObjectStackGoal": _stack_draws, "PickAndPlaceGoal": _pickandplace_draws,
              "ObjectFixedStateGoal": lambda *a: {}, "DominoStateGoal": _domino_draws,
              "AttachedBlockStateGoal": _attached_draws}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got).astype(np.float64), np.asarray(want, np.float64), rtol=0,
                               atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# the JAX envs and the port's
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def stand_in(root):
    """Inside, the JAX package composes its rearrange worlds from the
    stand-in's writer (an `MjcfXML`, which dominos appends its blocks to)
    and runs box-box pairs through its Pallas kernel."""
    def write(max_num_objects, block_size=0.0254, robot_control_params=None,
              mujoco_timestep=0.001):
        rcp = robot_control_params or j_comp.RobotControlParameters()
        return MjcfXML.from_string(rearrange_blocks_like.write(
            tempfile.mkdtemp(dir=root), max_num_objects, block_size, rcp.is_joint_actuated(),
            mujoco_timestep))

    orig = j_sim.build_blocks_world_xml
    j_sim.build_blocks_world_xml = write
    try:
        with jax_boxbox_kernel():
            yield
    finally:
        j_sim.build_blocks_world_xml = orig


@pytest.fixture(scope="module")
def jax_train(tmp_path_factory):
    with stand_in(str(tmp_path_factory.mktemp("train"))):
        return j_train.make_env(TRAIN_CONSTANTS, TRAIN_PARAMETERS)


@pytest.fixture(scope="module")
def jax_dominos(tmp_path_factory):
    with stand_in(str(tmp_path_factory.mktemp("dominos"))):
        return j_dominos.make_env({"stabilize_steps": 1, "is_holdout": True},
                                  {"simulation_params": {"num_objects": 2, "max_num_objects": O}})


def port_worlds(jenv):
    """The JAX env's compiled models through the bridge, on the CPU."""
    out = {"model": _port_model(jenv.model), "solver_model": _port_model(jenv.solver_model)}
    if jenv._settle_model is not None:
        out["settle_model"] = _port_model(jenv._settle_model)
    return out


def from_jax_start(env, jenv):
    """The port's env, started from the JAX env's settled initial state."""
    env._initial_data = t_core.data_map(lambda x: x[None], bridge.data_from_numpy(
        bridge.data_to_numpy(jenv._initial_data), "cpu"))
    return env


@pytest.fixture(scope="module")
def port_train(jax_train):
    return from_jax_start(t_train.make_env(TRAIN_CONSTANTS, TRAIN_PARAMETERS, device="cpu",
                                           worlds=port_worlds(jax_train)), jax_train)


def jax_variant(jax_train, cls, constants, num_objects, goal_gen):
    """A copy of the JAX blocks_train env as the JAX `make_env` of another
    env of the family would build it on the same world: its class (for
    `_sample_object_groups` and `_reset_model_fields`), constants, object
    count and goal generator `goal_gen(env, GoalArgs)`."""
    env = copy.copy(jax_train)
    env.__class__ = cls
    sp = dataclasses.replace(jax_train.parameters.simulation_params, num_objects=num_objects)
    env.parameters = j_blocks.RearrangeEnvParameters(
        simulation_params=sp, robot_control_params=jax_train.parameters.robot_control_params)
    env.constants = dataclasses.replace(constants, max_timesteps_per_goal=(
        constants.max_timesteps_per_goal_per_obj * num_objects))
    kw = dict(used_table_portion=sp.used_table_portion)
    env.goal_gen = goal_gen(env, j_goals.GoalArgs(**dict(constants.goal_args)), kw)
    return env


def _word_goal(env, args, kw):
    """wordblocks.py:51-71's fixed row, at this env's object slots."""
    n = env.max_num_objects
    rel = np.stack([np.linspace(0.2, 0.8, n), np.full(n, 0.5)], axis=1)
    quats = np.tile(np.asarray([[1.0, 0, 0, 0]]), (n, 1))
    tilt = np.asarray(j_rot.quat_from_angle_and_axis(jnp.asarray(0.38), jnp.asarray([0.0, 0, 1.0])))
    for i in (4, 5):
        if i < n:
            quats[i] = tilt
    return j_goals.ObjectFixedStateGoal(env.idx, j_goals.GoalArgs(), relative_placements=rel,
                                        init_quats=quats, **kw)


BASE = j_blocks.RearrangeEnvConstants
# name: (port make_env, its constants, its simulation parameters, JAX class,
#        JAX constants, objects in use, JAX goal generator)
VARIANTS = {
    "reach": (t_reach.make_env, {}, {}, j_blocks.BlocksRearrangeEnv,
              BASE(stabilize_steps=1, goal_generation="reach"), 1,
              lambda e, a, kw: j_goals.ObjectReachGoal(e.idx, e.robot.arm, a, **kw)),
    "det-reach": (t_reach.make_env, {"goal_generation": "det-state"}, {},
                  j_blocks.BlocksRearrangeEnv, BASE(stabilize_steps=1, goal_generation="det-reach"),
                  1, lambda e, a, kw: j_goals.DeterministicReachGoal(e.idx, e.robot.arm, a, **kw)),
    "stack": (t_stack.make_env, {}, {}, j_blocks.BlocksRearrangeEnv,
              BASE(stabilize_steps=1, goal_generation="stack"), 2,
              lambda e, a, kw: j_goals.ObjectStackGoal(e.idx, a, fixed_order=False, **kw)),
    "pickandplace": (t_pickandplace.make_env, {}, {"num_objects": 2}, j_blocks.BlocksRearrangeEnv,
                     BASE(stabilize_steps=1, goal_generation="pickandplace"), 2,
                     lambda e, a, kw: j_goals.PickAndPlaceGoal(e.idx, a, **kw)),
    "attached": (t_attached.make_env, {}, {"num_objects": O}, j_blocks.BlocksRearrangeEnv,
                 BASE(stabilize_steps=1), O,
                 lambda e, a, kw: j_attached.AttachedBlockStateGoal(e.idx, j_goals.GoalArgs(),
                                                                    **kw)),
    "duplicate": (t_duplicate.make_env, {}, {"num_objects": 2},
                  j_duplicate.DuplicateBlockRearrangeEnv, BASE(stabilize_steps=1), 2,
                  lambda e, a, kw: j_goals.ObjectStateGoal(e.idx, a, **kw)),
    "wordblocks": (t_word.make_env, {"rainbow_mode": True}, {"num_objects": O},
                   j_word.WordBlocksEnv,
                   j_word.WordBlocksEnvConstants(stabilize_steps=1, rainbow_mode=True), O,
                   _word_goal),
}


# ---------------------------------------------------------------------------
# draws from the JAX keys
# ---------------------------------------------------------------------------

def _goal_draws(jenv, key):
    return GOAL_DRAWS[type(jenv.goal_gen).__name__](key, jenv.num_objects, jenv.max_num_objects,
                                                     jenv.goal_gen.args)


def _stack(per):
    out = {}
    for k in per[0]:
        if isinstance(per[0][k], dict):
            out[k] = _stack([p[k] for p in per])
        else:
            out[k] = None if per[0][k] is None else _t(np.stack([np.asarray(p[k]) for p in per]))
    return out


def _mask_draws(jenv, k_goal, k_state):
    """The soft masks' draws: the goal's from k_goal folded with 7
    (blocks.py:695), the observation's from the state's key folded with 13
    (blocks.py:786)."""
    if not jenv.goal_gen.args.soft_mask:
        return {}
    out = {"goal_mask_u": jax.random.uniform(jax.random.fold_in(k_goal, 7), (), jnp.float32)}
    if jenv.constants.mask_obs_outside_placement_area:
        out["obs_mask_u"] = jax.random.uniform(jax.random.fold_in(k_state, 13), (), jnp.float32)
    return out


def jax_reset_draws(jenv, keys):
    """The port's `reset` draws from the JAX reset keys (blocks.py:384-438,
    blocks_train.py:34-45, blocks_duplicate.py:11-18)."""
    per = []
    for key in keys:
        k_place, k_rot, _, k_goal, k_pause, k_state, k_model = jax.random.split(key, 7)
        k_grp, _, _ = jax.random.split(k_model, 3)
        k_lam, k_cat, k_col = jax.random.split(k_grp, 3)
        color = np.array(jax.random.uniform(k_col, (O, 3), jnp.float32))
        if isinstance(jenv, j_duplicate.DuplicateBlockRearrangeEnv):
            color[0] = np.asarray(jax.random.uniform(k_grp, (3,), jnp.float32))
        d = dict(lam_u=jax.random.uniform(k_lam, (), jnp.float32),
                 gumbel=np.stack([np.asarray(jax.random.gumbel(k, (O,), jnp.float32))
                                  for k in jax.random.split(k_cat, O)]),
                 color_u=color,
                 place_u=np.stack([np.asarray(jax.random.uniform(k, (20, 2), jnp.float32))
                                   for k in jax.random.split(k_place, O)]),
                 place_rot_u=np.asarray([jax.random.uniform(k, ())
                                         for k in jax.random.split(k_rot, O)]),
                 goal=_goal_draws(jenv, k_goal), pause_u=jax.random.uniform(k_pause, ()),
                 **_mask_draws(jenv, k_goal, k_state))
        if getattr(jenv.constants, "use_cuboid", False):
            d["scale_u"] = jax.random.uniform(jax.random.fold_in(k_model, 17), (O, 3), jnp.float32)
        per.append(d)
    return _stack(per)


def jax_step_draws(jenv, jstate):
    """The port's `step` draws from the JAX state's keys (blocks.py:593)."""
    per = []
    for key in np.asarray(jstate.key):
        new_key, k_goal, k_pause = jax.random.split(jnp.asarray(key), 3)
        per.append(dict(goal=_goal_draws(jenv, k_goal), pause_u=jax.random.uniform(k_pause, ()),
                        **_mask_draws(jenv, k_goal, new_key)))
    return _stack(per)


# ---------------------------------------------------------------------------
# runs and comparisons
# ---------------------------------------------------------------------------

def _nudge(d, seed):
    gen = torch.Generator().manual_seed(seed)
    return d.replace(qvel=d.qvel + NUDGE * torch.randn(d.qvel.shape, generator=gen,
                                                       dtype=d.qvel.dtype))


@contextlib.contextmanager
def nudged_settle(seed):
    """Inside, the port's goal settle (`BlocksRearrangeEnv._stabilize_goal`)
    starts from velocities nudged by NUDGE."""
    physics, settle = t_blocks.physics, t_blocks.BlocksRearrangeEnv._stabilize_goal
    shim = types.SimpleNamespace(step_n=lambda m, d, n: physics.step_n(m, _nudge(d, seed), n))

    def stabilize(self, goal):
        t_blocks.physics = shim
        try:
            return settle(self, goal)
        finally:
            t_blocks.physics = physics

    t_blocks.BlocksRearrangeEnv._stabilize_goal = stabilize
    try:
        yield
    finally:
        t_blocks.BlocksRearrangeEnv._stabilize_goal = settle


def port_reset(env, draws, n=3):
    """The port's reset on `draws`, and its runs from the initial state's
    velocities nudged by NUDGE, the goal settle's too."""
    out = env.reset(B, draws)
    d0, nudged = env._initial_data, []
    for s in range(n):
        env._initial_data = _nudge(d0, s)
        try:
            with nudged_settle(100 + s):
                nudged.append(env.reset(B, draws)[0])
        finally:
            env._initial_data = d0
    return out, nudged


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) and x.is_floating_point() else x


def float64_step(env, tstate, action, draws):
    """The port's step in float64 from the same state: a run perturbed by
    rounding alone."""
    names = ("model", "solver_model", "_settle_model")
    models = {k: getattr(env, k) for k in names}
    for k, m in models.items():
        if m is not None:
            setattr(env, k, bridge.model_to(m, "cpu", torch.float64))
    f64 = {k: {n: _f64(v) for n, v in getattr(tstate, k).items()}
           for k in ("goal", "prev_goal_distance", "model_fields")}
    try:
        return env.step(tstate.replace(physics=t_core.data_map(_f64, tstate.physics),
                                       goal_aux=t_core.data_map(_f64, tstate.goal_aux), **f64),
                        action.double(), draws=draws)[0]
    finally:
        for k, m in models.items():
            setattr(env, k, m)


def port_step(env, tstate, action, draws, n=3):
    """The port's step, its runs from both sims' velocities nudged by
    NUDGE, the goal settle's too, and its run in float64."""
    out = env.step(tstate, action, draws=draws)
    nudged = []
    for s in range(n):
        st = tstate.replace(physics=_nudge(tstate.physics, s), goal_aux=_nudge(tstate.goal_aux,
                                                                               50 + s))
        with nudged_settle(100 + s):
            nudged.append(env.step(st, action, draws=draws)[0])
    return out, nudged + [float64_step(env, tstate, action, draws)]


def _goal_state(goal):
    """A settled goal's poses as a physics state for the envelope: qpos the
    objects' (position, quaternion) rows, no velocity."""
    qpos = np.concatenate([_np(goal["obj_pos"]), _np(goal["obj_rot"])], -1)
    return {"qpos": qpos.reshape(qpos.shape[0], -1), "qvel": np.zeros((qpos.shape[0], 1))}


# observations that are euler angles of quaternions held to QPOS_TOL: an
# angle moves by up to twice a component
EULER = ("obj_rot", "goal_obj_rot", "rel_goal_obj_rot")
GOAL_IDX = types.SimpleNamespace(cube_pos_qpos=(7 * np.arange(O)[:, None] + np.arange(3)).ravel())


def compare_state(tstate, tobs, jstate, jobs, env, nudged, settled):
    """Physics by the nudge rule over the whole batch; a settled goal's
    poses the same way (`_goal_state`), else the goal 1e-6 abs; the obs on
    the envs within every envelope. Returns those envs."""
    td, jd = bridge.data_to_numpy(tstate.physics), bridge.data_to_numpy(jstate.physics)
    assert_physics_close(td, jd, _objects(env), [bridge.data_to_numpy(n.physics) for n in nudged],
                         whole=True)
    calm = _within_envelope(td, jd, env)
    pose_keys = ("obj_pos", "obj_rot") if settled else ()
    if settled:
        tg, jg = _goal_state(tstate.goal), _goal_state(jstate.goal)
        assert_physics_close(tg, jg, GOAL_IDX, [_goal_state(n.goal) for n in nudged], whole=True)
        for _, field, cols, tol in _groups(GOAL_IDX):
            calm &= _env_err(tg, jg, field, cols) <= tol
    assert sorted(tstate.goal) == sorted(jstate.goal)
    for k, v in jstate.goal.items():
        if k in pose_keys:
            continue
        if settled and k in ("goal_objects_in_placement_area", "goal_in_placement_area"):
            np.testing.assert_array_equal(_np(tstate.goal[k])[calm], np.asarray(v)[calm], err_msg=k)
        else:
            _close(tstate.goal[k], v, 1e-6, msg=k)
    assert sorted(tobs) == sorted(jobs) and calm.any()
    for k in tobs:
        t, j = _np(tobs[k]), np.asarray(jobs[k])
        assert t.shape == j.shape and np.isfinite(t).all(), k
        base = k[len("masked_"):] if k.startswith("masked_") else k
        if base in ("tcp_force", "tcp_torque", "safety_stop", "obj_gripper_contact"):
            continue        # contact forces: checked by test_torch_rearrange.py on one state
        _close(t[calm], j[calm], 2 * QPOS_TOL if base in EULER else _obs_tol(base), msg=k)
    return calm


def compare_step(tout, jout, env, nudged, settled):
    (ts, tobs, trew, tdone, tinfo), (js, jobs, jrew, jdone, jinfo) = tout, jout
    compare_state(ts, tobs, js, jobs, env, nudged, settled)
    np.testing.assert_array_equal(_np(trew), np.asarray(jrew))
    np.testing.assert_array_equal(_np(tdone), np.asarray(jdone))
    assert sorted(tinfo) == sorted(jinfo)
    for k in tinfo:
        t, j = _np(tinfo[k]), np.asarray(jinfo[k])
        if t.dtype.kind == "f":
            _close(t, j, 1e-6, msg=k)
        else:
            np.testing.assert_array_equal(t, j, err_msg=k)
    for f in dataclasses.fields(t_core.TrackerState):
        np.testing.assert_array_equal(_np(getattr(ts.tracker, f.name)),
                                      np.asarray(getattr(js.tracker, f.name)), err_msg=f.name)


def jax_run(fn, *args):
    with jax_boxbox_kernel():
        return fn(*args)


def check_reset_and_step(env, jenv, seed, settled, steps=1):
    """`reset` on the JAX keys' draws against the JAX reset, then `steps`
    env steps, each from the JAX state carried across, actions uniform in
    [-1, 1]. Returns the last JAX state."""
    keys = jax.random.split(jax.random.PRNGKey(seed), B)
    jstate, jobs = jax_run(jax.jit(jax.vmap(jenv.reset)), keys)
    (tstate, tobs), nudged = port_reset(env, jax_reset_draws(jenv, keys))
    compare_state(tstate, tobs, jstate, jobs, env, nudged, settled)
    for k, v in jstate.model_fields.items():
        np.testing.assert_allclose(_np(tstate.model_fields[k]), np.asarray(v), rtol=1e-6, atol=0,
                                   err_msg=k)
    for f in dataclasses.fields(t_core.TrackerState):
        np.testing.assert_array_equal(_np(getattr(tstate.tracker, f.name)),
                                      np.asarray(getattr(jstate.tracker, f.name)), err_msg=f.name)
    step = jax.jit(jax.vmap(jenv.step))
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        action = rng.uniform(-1, 1, (B, env.action_size)).astype(np.float32)
        tout, nudged = port_step(env, _to_port(jstate), _t(action), jax_step_draws(jenv, jstate))
        jout = jax_run(step, jstate, jnp.asarray(action))
        compare_step(tout, jout, env, nudged, settled=False)
        jstate = jout[0]
    return jstate, step


# ---------------------------------------------------------------------------
# blocks_train
# ---------------------------------------------------------------------------

def test_train_construction(port_train, jax_train):
    """The settle world (floor, table, 3 blocks: nv=18, no actuator, no
    equality) through the bridge; the port's arm-to-tabletop settle against
    the JAX env's within the envelope; the goal generator, a train one, with
    the options of TRAIN_CONSTANTS."""
    sm = port_train._settle_model
    assert (sm.const.nv, sm.const.nu, sm.const.neq) == (18, 0, 0)
    assert sm.opt.ncon_active == 32 and sm.opt.group_cap == 48
    assert isinstance(port_train.goal_gen, t_goals.TrainStateGoal)
    args = port_train.goal_gen.args
    assert args.stabilize_goal and args.soft_mask and args.pickup_proba == 0.3
    td = bridge.data_to_numpy(t_train.make_env(
        TRAIN_CONSTANTS, TRAIN_PARAMETERS, device="cpu",
        worlds=port_worlds(jax_train))._initial_data)
    jd = {k: v[None] for k, v in bridge.data_to_numpy(jax_train._initial_data).items()}
    assert_physics_close(td, jd, _objects(port_train))


def test_train_settle_world_step_matches_jax(port_train, jax_train):
    """Forty substeps of the settle world from seeded goal poses (blocks
    dropped from up to 0.1 m, one stacked on another): the port's settle
    Data by the nudge rule against the JAX step_n; `_stabilize_goal` gives
    that run's poses bit for bit."""
    from robogym_torch.physics import step as t_step
    from robogym_tpu.physics import step as j_step

    rng = np.random.default_rng(21)
    lo, hi = port_train.idx.placement_bounds(2)
    pos = rng.uniform(lo, hi, (B, O, 3)).astype(np.float32)
    pos[..., 2] = lo[2] + 0.0254 + rng.uniform(0.0, 0.1, (B, O))
    pos[:, 1, :2] = pos[:, 0, :2] + 0.01
    pos[:, 1, 2] = pos[:, 0, 2] + 0.06
    quat = rng.standard_normal((B, O, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    sm, sidx = port_train._settle_model, port_train._settle_idx
    n_sub = port_train.constants.stabilize_steps * port_train.constants.mujoco_substeps
    jsm, jsidx = jax_train._settle_model, jax_train._settle_idx
    jd = jax_run(jax.jit(jax.vmap(lambda p, q: j_step.step_n(
        jsm, j_sim.set_object_poses(jsidx, jax_train._settle_data, p, q), n_sub))), pos, quat)
    start = t_blocks.sim_lib.set_object_poses(sidx, t_blocks.make_data(sm, B), _t(pos), _t(quat))
    runs = [t_step.step_n(sm, d, n_sub) for d in [start] + [_nudge(start, s) for s in range(3)]]
    idx = types.SimpleNamespace(cube_pos_qpos=(sidx.object_qpos_adr[:, None]
                                               + np.arange(3)).ravel())
    td = bridge.data_to_numpy(runs[0])
    assert_physics_close(td, bridge.data_to_numpy(jd), idx,
                         [bridge.data_to_numpy(r) for r in runs[1:]], whole=True)
    goal = port_train._stabilize_goal({"obj_pos": _t(pos), "obj_rot": _t(quat)})
    assert torch.equal(goal["obj_pos"], t_blocks.sim_lib.object_positions(sidx, runs[0]))
    assert torch.equal(goal["obj_rot"], t_blocks.sim_lib.object_quats(sidx, runs[0]))


@pytest.fixture(scope="module")
def train_run(port_train, jax_train):
    """reset and two steps of blocks_train (`check_reset_and_step`)."""
    return check_reset_and_step(port_train, jax_train, seed=5, settled=True, steps=2)


def test_train_reset_and_two_steps_match_jax(train_run, port_train):
    """`reset` (each env's cuboid sizes, masses and inertias, the settled
    first goal with its soft placement mask, the masked observations) and
    two steps, as `check_reset_and_step` holds them; some env's blocks are
    not cubes."""
    jstate, _ = train_run
    size = np.asarray(jstate.model_fields["geom_size"])[:, port_train.idx.object_geom_ids]
    assert np.abs(size - 0.0254).max() > 1e-3


def test_train_goal_resample_matches_jax(train_run, port_train, jax_train):
    """A step in which envs 0 and 2 resample their goal: the new train
    goals settled in the settle world, by the nudge rule; env 1 keeps its
    goal."""
    jstate, step = train_run
    jstate = jstate.replace(tracker=jstate.tracker.replace(
        success_and_no_goal_reset=jnp.asarray([True, False, True])))
    action = np.random.default_rng(12).uniform(-1, 1, (B, 6)).astype(np.float32)
    jout = jax_run(step, jstate, jnp.asarray(action))
    np.testing.assert_array_equal(np.asarray(jout[0].tracker.goals_so_far)[[0, 2]], [2, 2])
    tout, nudged = port_step(port_train, _to_port(jstate), _t(action),
                             jax_step_draws(jax_train, jstate))
    compare_step(tout, jout, port_train, nudged, settled=True)
    moved = np.abs(_np(tout[0].goal["obj_pos"]) - np.asarray(jstate.goal["obj_pos"])).max((1, 2))
    assert moved[0] > 0 and moved[1] == 0 and moved[2] > 0


# ---------------------------------------------------------------------------
# dominos and the other envs
# ---------------------------------------------------------------------------

def test_dominos_holdout_reset_and_step_match_jax(jax_dominos):
    """dominos under `is_holdout` on its world (blocks of half-size 0.0254 x
    (0.2, 1, 2)): the arc goals, reset and one step."""
    env = from_jax_start(t_dominos.make_env(
        {"stabilize_steps": 1, "is_holdout": True},
        {"simulation_params": {"num_objects": 2, "max_num_objects": O}}, device="cpu",
        worlds=port_worlds(jax_dominos)), jax_dominos)
    assert isinstance(env.goal_gen, t_goals.DominoStateGoal)
    assert env.goal_gen.args.rot_dist_type == "mod180"
    np.testing.assert_allclose(_np(env.model.geom_size[env.idx.object_geom_ids]),
                               np.tile(0.0254 * rearrange_blocks_like.DOMINO_PROPORTIONS, (O, 1)),
                               rtol=1e-6)
    check_reset_and_step(env, jax_dominos, seed=6, settled=False)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_env_reset_and_step_match_jax(name, jax_train):
    """reach, det-reach, stack, pick-and-place, attached, duplicate and
    wordblocks (rainbow): the port's `make_env` against the JAX env as its
    `make_env` builds it (`jax_variant`), reset and one step."""
    make, cst, sim, cls, jcst, n, goal_gen = VARIANTS[name]
    jenv = jax_variant(jax_train, cls, jcst, n, goal_gen)
    env = from_jax_start(make(dict(cst, stabilize_steps=1), {"simulation_params": dict(
        sim, max_num_objects=O)}, device="cpu", worlds=port_worlds(jax_train)), jenv)
    assert env.num_objects == n and type(env.goal_gen).__name__ == type(jenv.goal_gen).__name__
    check_reset_and_step(env, jenv, seed=7 + len(name), settled=False)
