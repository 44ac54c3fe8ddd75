"""The port's rearrange blocks env against the JAX package's, on the CPU,
at a small size: `max_num_objects=3`, `num_objects=2`, `stabilize_steps=1`,
B=3, the default control (TCP position, roll and yaw through the mocap_ik
dual sim, the force limiter on).

The JAX env is built on the UR16e-shaped stand-in
(`robogym_torch/worlds/rearrange_blocks_like.py`) by pointing
`simulation.build_blocks_world_xml`, in this process only, at the world's
writer; its box-box pairs run through its Pallas kernel in interpret mode
(`jax_boxbox_kernel`). The port's env gets the JAX env's compiled models
through the bridge. Random draws are made from the JAX keys (the same
splits as the JAX functions make, in the dtype each JAX call uses: float64
where it names none, as the test suite turns x64 on) and fed to the port's
apply functions. States cross by `bridge.env_state_to_numpy` /
`env_state_from_numpy`.

Tolerances: the robot, goal and simulation functions on the same states
1e-5 abs (float32 formulas in another order); draws-driven outputs
(placements, group ids, colours) 1e-6 abs or exactly; the physics of the
construction's settle, the reset and each step by the env-step envelope of
`_torch_common.assert_physics_close` (objects 2e-4 m, qpos 1e-3, qvel 5e-2)
with its nudge rule over the whole batch for the reset and the steps (its
largest drift from JAX at most twice its largest drift under a 1e-6 nudge
of both sims' qvel); on the envs within the envelope obs
within 1e-4 of the JAX obs after a step (1e-3 for those that carry qpos
or joint angles, and 5e-2 for velocities, the envelope's), rewards, done,
the tracker and the info's integers and booleans exactly."""

import dataclasses
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import (QPOS_TOL, QVEL_TOL, _env_err, _groups, assert_physics_close,
                           jax_boxbox_kernel, jax_data_from_numpy, nudged_runs)
from robogym_torch import bridge
from robogym_torch.envs import core as t_core
from robogym_torch.envs.rearrange import blocks as t_blocks
from robogym_torch.envs.rearrange import goals as t_goals
from robogym_torch.envs.rearrange import simulation as t_sim
from robogym_torch.robot import composite as t_comp
from robogym_torch.robot import gripper as t_grip
from robogym_torch.robot import tcp_force_limiter as t_lim
from robogym_torch.robot import tcp_solver as t_tcp
from robogym_torch.robot import ur16e as t_arm
from robogym_torch.utils import rotation as t_rot
from robogym_torch.worlds import rearrange_blocks_like
from robogym_tpu.envs import core as j_core
from robogym_tpu.envs.rearrange import blocks as j_blocks
from robogym_tpu.envs.rearrange import goals as j_goals
from robogym_tpu.envs.rearrange import simulation as j_sim
from robogym_tpu.robot import composite as j_comp
from robogym_tpu.robot import gripper as j_grip
from robogym_tpu.robot import tcp_force_limiter as j_lim
from robogym_tpu.robot import tcp_solver as j_tcp
from robogym_tpu.robot import ur16e as j_arm
from robogym_tpu.utils import rotation as j_rot

B = 3
O = 3
CONSTANTS = {"stabilize_steps": 1}
PARAMETERS = {"simulation_params": {"num_objects": 2, "max_num_objects": O}}
TOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol=TOL, msg=""):
    np.testing.assert_allclose(_np(got).astype(np.float64), np.asarray(want, np.float64), rtol=0,
                               atol=tol, err_msg=msg)


# ---------------------------------------------------------------------------
# the two envs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_env(tmp_path_factory):
    """The JAX BlocksRearrangeEnv on the stand-in world:
    `build_blocks_world_xml` writes it while the env is built."""
    root = str(tmp_path_factory.mktemp("rearrange"))

    def write(max_num_objects, block_size=0.0254, robot_control_params=None,
              mujoco_timestep=0.001):
        rcp = robot_control_params or j_comp.RobotControlParameters()
        return rearrange_blocks_like.write(tempfile.mkdtemp(dir=root), max_num_objects,
                                           block_size, rcp.is_joint_actuated(), mujoco_timestep)

    orig = j_sim.build_blocks_world_xml
    j_sim.build_blocks_world_xml = write
    try:
        with jax_boxbox_kernel():
            return j_blocks.make_env(CONSTANTS, PARAMETERS)
    finally:
        j_sim.build_blocks_world_xml = orig


def _port_model(jmodel):
    return bridge.model_from_numpy(bridge.model_to_numpy(jmodel), "cpu")


@pytest.fixture(scope="module")
def port_env(jax_env):
    sp = t_blocks.RearrangeSimParameters(**PARAMETERS["simulation_params"])
    return t_blocks.BlocksRearrangeEnv(
        t_blocks.RearrangeEnvConstants(**CONSTANTS), t_blocks.RearrangeEnvParameters(sp),
        _port_model(jax_env.model), _port_model(jax_env.solver_model), seed=0)


def _uniform_quat_u(key):
    return np.asarray([jax.random.uniform(k) for k in jax.random.split(key, 3)])


def _goal_draws(k_goal):
    """`ObjectStateGoal.next_goal`'s draws from its key (no rotation draws:
    the default goals keep the identity)."""
    k_pos, _ = jax.random.split(k_goal)
    return np.stack([np.asarray(jax.random.uniform(k, (t_goals.N_CANDIDATES, 2), jnp.float32))
                     for k in jax.random.split(k_pos, O)])


def jax_reset_draws(keys):
    """The port's `reset` draws from the JAX reset keys (blocks.py:384-438)."""
    out = {k: [] for k in ("lam_u", "gumbel", "color_u", "place_u", "place_rot_u", "goal",
                           "pause_u")}
    for key in keys:
        k_place, k_rot, _, k_goal, k_pause, _, k_model = jax.random.split(key, 7)
        k_grp, _, _ = jax.random.split(k_model, 3)
        k_lam, k_cat, k_col = jax.random.split(k_grp, 3)
        out["lam_u"].append(np.float32(jax.random.uniform(k_lam, (), jnp.float32)))
        out["gumbel"].append(np.stack([np.asarray(jax.random.gumbel(k, (O,), jnp.float32))
                                       for k in jax.random.split(k_cat, O)]))
        out["color_u"].append(np.asarray(jax.random.uniform(k_col, (O, 3), jnp.float32)))
        out["place_u"].append(np.stack([np.asarray(jax.random.uniform(
            k, (t_goals.N_CANDIDATES, 2), jnp.float32)) for k in jax.random.split(k_place, O)]))
        out["place_rot_u"].append(np.asarray([jax.random.uniform(k, ())
                                              for k in jax.random.split(k_rot, O)]))
        out["goal"].append(_goal_draws(k_goal))
        out["pause_u"].append(np.asarray(jax.random.uniform(k_pause, ())))
    draws = {k: _t(np.stack(v)) for k, v in out.items()}
    draws["goal"] = {"pos_u": draws["goal"], "rot_u": None}
    return draws


def jax_step_draws(state):
    """The port's `step` draws from the JAX state's keys."""
    goal, pause = [], []
    for key in np.asarray(state.key):
        _, k_goal, k_pause = jax.random.split(jnp.asarray(key), 3)
        goal.append(_goal_draws(k_goal))
        pause.append(np.asarray(jax.random.uniform(k_pause, ())))
    return {"goal": {"pos_u": _t(np.stack(goal)), "rot_u": None}, "pause_u": _t(np.stack(pause))}


@pytest.fixture(scope="module")
def jax_reset(jax_env):
    keys = jax.random.split(jax.random.PRNGKey(5), B)
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


def jax_env_state(arrays, keys):
    """The JAX package's batched EnvState from an `env_state_to_numpy` dict."""
    def group(prefix):
        return {k[len(prefix):]: jnp.asarray(v) for k, v in arrays.items() if k.startswith(prefix)}

    def data(prefix):
        return jax_data_from_numpy({k[len(prefix):]: v for k, v in arrays.items()
                                    if k.startswith(prefix)})

    tracker = j_core.TrackerState(**{f.name: jnp.asarray(arrays["tracker." + f.name])
                                     for f in dataclasses.fields(j_core.TrackerState)})
    return j_core.EnvState(physics=data("physics."), goal=group("goal."),
                           goal_aux=data("goal_aux.data."),
                           prev_goal_distance=group("prev_goal_distance."), tracker=tracker,
                           key=jnp.asarray(keys), t=jnp.asarray(arrays["t"]),
                           model_fields=group("model_fields.") or None)


def _objects(env):
    """The physics envelope's index: the objects' position columns."""
    adr = np.asarray(env.idx.object_qpos_adr)
    return types.SimpleNamespace(cube_pos_qpos=(adr[:, None] + np.arange(3)).ravel())


def _to_port(jstate):
    return bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")


def _port_data(jd):
    return bridge.data_from_numpy(bridge.data_to_numpy(jd), "cpu")


# ---------------------------------------------------------------------------
# indices, robot functions
# ---------------------------------------------------------------------------

def test_indices_bind(port_env, jax_env):
    """The arm, gripper and world index tables of both packages agree, on
    the main and the solver world; the world's nv is 6 + 6 + 6 O."""
    pairs = [(port_env.robot.arm, jax_env.robot.arm), (port_env.robot.gripper, jax_env.robot.gripper),
             (port_env.solver_robot.arm, jax_env.solver_robot.arm),
             (port_env.solver_robot.gripper, jax_env.solver_robot.gripper),
             (port_env.idx, jax_env.idx)]
    for t, j in pairs:
        for f in dataclasses.fields(t):
            np.testing.assert_array_equal(np.asarray(getattr(t, f.name)),
                                          np.asarray(getattr(j, f.name)), err_msg=f.name)
    assert port_env.robot.arm.actuator_ids.size == 6 and port_env.solver_robot.arm.actuator_ids.size == 0
    assert port_env.model.const.nv == 12 + 6 * O
    for n in (1, 2, 5):
        for u in (0.3, 1.0):
            for a, b in zip(port_env.idx.placement_bounds(n, u), jax_env.idx.placement_bounds(n, u)):
                np.testing.assert_array_equal(a, b)
    rcp, jrcp = t_comp.RobotControlParameters(), j_comp.RobotControlParameters()
    for mode in ("tcp+roll+yaw", "tcp+wrist", "joint"):
        for solver in ("mocap", "mocap_ik"):
            t = dataclasses.replace(rcp, control_mode=mode, tcp_solver_mode=solver)
            j = dataclasses.replace(jrcp, control_mode=mode, tcp_solver_mode=solver)
            for name in ("is_joint_actuated", "is_tcp_controlled", "requires_solver_sim",
                         "action_dims", "default_max_position_change"):
                assert getattr(t, name)() == getattr(j, name)(), (mode, solver, name)


def test_arm_and_gripper_functions_match_jax(port_env, jax_env, jax_reset):
    """ur16e's observations and joint control, the gripper's, and the
    composite's joint control on the reset states, 1e-5 abs."""
    _, state, _ = jax_reset
    jd, d = state.physics, _port_data(state.physics)
    jm, m = jax_env.model, port_env.model
    arm, jarm = port_env.robot.arm, jax_env.robot.arm
    for name in ("joint_positions", "joint_velocities", "tcp_xyz", "tcp_quat", "tcp_rot"):
        _close(getattr(t_arm, name)(arm, d), jax.vmap(lambda x: getattr(j_arm, name)(jarm, x))(jd),
               msg=name)
    _close(t_arm.tcp_vel(arm, m, d), jax.vmap(lambda x: j_arm.tcp_vel(jarm, jm, x))(jd))
    rng = np.random.default_rng(1)
    for rel, change in ((True, 2.4), (False, None), (True, 0.1)):
        a = rng.uniform(-1.2, 1.2, (B, 6)).astype(np.float32)
        _close(t_arm.denormalize_position_control(arm, m, d, _t(a), rel, change),
               jax.vmap(lambda x, y: j_arm.denormalize_position_control(jarm, jm, x, y, rel,
                                                                        change))(jd, a))
    g, jg = port_env.robot.gripper, jax_env.robot.gripper
    for name in ("joint_position", "joint_velocity"):
        _close(getattr(t_grip, name)(g, d), jax.vmap(lambda x: getattr(j_grip, name)(jg, x))(jd))
    for rel in (True, False):
        a = rng.uniform(-1.2, 1.2, (B, 1)).astype(np.float32)
        _close(t_grip.denormalize_position_control(g, m, d, _t(a), rel),
               jax.vmap(lambda x, y: j_grip.denormalize_position_control(jg, jm, x, y, rel))(jd, a))
        a = rng.uniform(-1.2, 1.2, (B, 7)).astype(np.float32)
        _close(t_comp.set_position_control_joint(port_env.robot, m, d, _t(a), rel),
               jax.vmap(lambda x, y: j_comp.set_position_control_joint(jax_env.robot, jm, x, y,
                                                                      rel))(jd, a))


def test_regrasp_matches_jax():
    """40 steps of the regrasp state machine at B=64 on seeded commands
    (open, keep, close) and joint positions that close, stall and open:
    every output and state field exactly (selects over the same float32
    values)."""
    Bt = 64
    rng = np.random.default_rng(3)
    pos = rng.uniform(0.0, 0.8, Bt).astype(np.float32)
    ctrl = rng.uniform(0.0, 0.8, Bt).astype(np.float32)
    ts = t_grip.init_regrasp(_t(pos), _t(ctrl))
    js = jax.vmap(j_grip.init_regrasp)(jnp.asarray(pos), jnp.asarray(ctrl))
    step = jax.vmap(j_grip.compute_regrasp_control)
    triggered = False
    for _ in range(40):
        pc = rng.choice(np.asarray([-1.0, 0.0, 0.5, 1.0], np.float32), Bt)
        default = rng.uniform(0.0, 0.8, Bt).astype(np.float32)
        pos = (pos + rng.choice(np.asarray([-0.01, 0.0, 0.01], np.float32), Bt)).astype(np.float32)
        tout, ts = t_grip.compute_regrasp_control(ts, _t(pc), _t(default), _t(pos))
        jout, js = step(js, jnp.asarray(pc), jnp.asarray(default), jnp.asarray(pos))
        np.testing.assert_array_equal(_np(tout), np.asarray(jout))
        for f in dataclasses.fields(t_grip.RegraspState):
            np.testing.assert_array_equal(_np(getattr(ts, f.name)), np.asarray(getattr(js, f.name)),
                                          err_msg=f.name)
        triggered |= bool(_np(ts.regrasp_active).any())
    assert triggered


def test_tcp_solver_matches_jax(port_env, jax_env, jax_reset):
    """get_tcp_quat_delta (both control modes, the wrist mode with its
    axis alignment), reset_mocap_to_body, mocap_set_action and
    tcp_set_position_control on the reset states' solver sim, 1e-5 abs."""
    _, state, _ = jax_reset
    jd, d = state.goal_aux, _port_data(state.goal_aux)
    tcp = port_env.solver_robot.arm.tcp_body_id
    rng = np.random.default_rng(4)
    for dofs, align in ((t_tcp.TCP_ROLL_YAW_DOFS, t_tcp.TCP_ROLL_YAW_ALIGN),
                        (t_tcp.TCP_WRIST_DOFS, t_tcp.TCP_WRIST_ALIGN)):
        ang = rng.uniform(-0.5, 0.5, (B, len(dofs))).astype(np.float32)
        _close(t_tcp.get_tcp_quat_delta(d, tcp, _t(ang), dofs, align),
               jax.vmap(lambda x, a: j_tcp.get_tcp_quat_delta(x, tcp, a, dofs, align))(jd, ang))
    q = rng.standard_normal((B, 4)).astype(np.float32)
    _close(t_tcp.align_axis(_t(q), 2), jax.vmap(lambda x: j_tcp.align_axis(x, 2))(q))
    pos_d = rng.uniform(-0.05, 0.05, (B, 3)).astype(np.float32)
    quat_d = rng.uniform(-0.05, 0.05, (B, 4)).astype(np.float32)
    for got, want in (
        (t_tcp.reset_mocap_to_body(d, tcp), jax.vmap(lambda x: j_tcp.reset_mocap_to_body(x, tcp))(jd)),
        (t_tcp.mocap_set_action(d, _t(pos_d), _t(quat_d), tcp),
         jax.vmap(lambda x, p, r: j_tcp.mocap_set_action(x, p, r, tcp))(jd, pos_d, quat_d)),
    ):
        _close(got.mocap_pos, want.mocap_pos)
        _close(got.mocap_quat, want.mocap_quat)
    sm, jsm = port_env.solver_model, jax_env.solver_model
    for mode in ("tcp+roll+yaw", "tcp+wrist"):
        a = rng.uniform(-1, 1, (B, 5)).astype(np.float32)
        got = t_tcp.tcp_set_position_control(sm, d, tcp, _t(a), mode, 0.1)
        want = jax.vmap(lambda x, y: j_tcp.tcp_set_position_control(jsm, x, tcp, y, mode, 0.1))(
            jd, a)
        _close(got.mocap_pos, want.mocap_pos)
        _close(got.mocap_quat, want.mocap_quat)


def test_force_limiter_matches_jax():
    """Seeded |F| and |T| from 0 to 60 (below the trigger, the sigmoid
    band and above the maximum), 1e-5 abs; `triggered` exactly."""
    f = np.random.default_rng(5).uniform(0.0, 60.0, (256, 6)).astype(np.float32)
    got, trig = t_lim.get_element_wise_tcp_control_limits(_t(f))
    want, jtrig = jax.vmap(j_lim.get_element_wise_tcp_control_limits)(jnp.asarray(f))
    _close(got, want)
    np.testing.assert_array_equal(_np(trig), np.asarray(jtrig))


# ---------------------------------------------------------------------------
# rotation, goals and simulation helpers
# ---------------------------------------------------------------------------

def test_rotation_additions_match_jax():
    """euler2quat, quat2euler and uniform_z_quat on the JAX keys' float64
    draws, 1e-5 abs (angles)."""
    rng = np.random.default_rng(6)
    e = rng.uniform(-np.pi, np.pi, (64, 3)).astype(np.float32)
    _close(t_rot.euler2quat(_t(e)), j_rot.euler2quat(e))
    q = rng.standard_normal((64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    _close(t_rot.quat2euler(_t(q)), jax.vmap(j_rot.quat2euler)(q))
    keys = jax.random.split(jax.random.PRNGKey(2), 64)
    u = np.asarray([jax.random.uniform(k, ()) for k in keys])
    _close(t_rot.uniform_z_quat_apply(_t(u)).float(), jax.vmap(j_rot.uniform_z_quat)(keys))
    np.testing.assert_array_equal(t_rot.get_parallel_rotations_180(),
                                  j_rot.get_parallel_rotations_180())


def test_goal_sampling_matches_jax(port_env, jax_env):
    """sample_goal_positions and sample_goal_rotations ("z_axis", "full")
    on the JAX keys' draws, for the env's 2 of 3 objects and for 3 of 3 in
    a small area (where candidates are rejected): positions 1e-6 abs and
    the valid flags exactly; the object groups and colours of the reset's
    scan exactly and 1e-6."""
    sizes = np.asarray(jax_env._object_half_sizes())
    keys = jax.random.split(jax.random.PRNGKey(8), 16)
    for n, portion in ((2, 1.0), (3, 0.3)):
        active = np.arange(O) < n
        want = jax.vmap(lambda k: j_goals.sample_goal_positions(
            k, jax_env.idx, jnp.asarray(active), jnp.asarray(sizes), n, portion))(keys)
        u = np.stack([np.stack([np.asarray(jax.random.uniform(kk, (t_goals.N_CANDIDATES, 2),
                                                              jnp.float32))
                                for kk in jax.random.split(k, O)]) for k in keys])
        got = t_goals.sample_goal_positions(_t(u), port_env.idx, _t(active), _t(sizes), n, portion)
        _close(got[0], want[0], 1e-6)
        np.testing.assert_array_equal(_np(got[1]), np.asarray(want[1]))
    for kind, width in (("z_axis", 0), ("full", 3)):
        args = j_goals.GoalArgs(randomize_goal_rot=True, rot_randomize_type=kind)
        want = jax.vmap(lambda k: j_goals.sample_goal_rotations(k, O, args))(keys)
        u = np.stack([np.stack([_uniform_quat_u(kk) if width else np.asarray(
            jax.random.uniform(kk, ())) for kk in jax.random.split(k, O)]) for k in keys])
        got = t_goals.sample_goal_rotations(_t(u), 16, O, t_goals.GoalArgs(
            randomize_goal_rot=True, rot_randomize_type=kind))
        _close(got, want, 1e-6)
    draws = jax_reset_draws(keys)
    gid, colors = port_env.sample_object_groups(draws["lam_u"], draws["gumbel"], draws["color_u"])
    jgid, jcolors = jax.vmap(lambda k: jax_env._sample_object_groups(
        jax.random.split(jax.random.split(k, 7)[6], 3)[0]))(keys)
    np.testing.assert_array_equal(_np(gid), np.asarray(jgid))
    _close(colors, jcolors, 1e-6)


def test_rot_distance_and_matching_match_jax():
    """rot_distance and relative_rot_euler ("full", "mod90", "mod180"),
    and greedy_group_match on seeded positions with duplicate groups,
    1e-5 abs and the matches exactly."""
    rng = np.random.default_rng(9)
    q1 = rng.standard_normal((8, O, 4)).astype(np.float32)
    q2 = rng.standard_normal((8, O, 4)).astype(np.float32)
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    q2 /= np.linalg.norm(q2, axis=-1, keepdims=True)
    for kind in ("full", "mod90", "mod180"):
        _close(t_goals.rot_distance(_t(q1), _t(q2), kind),
               jax.vmap(lambda a, b: j_goals.rot_distance(a, b, kind))(q1, q2), msg=kind)
        _close(t_goals.relative_rot_euler(_t(q1), _t(q2), kind),
               jax.vmap(lambda a, b: j_goals.relative_rot_euler(a, b, kind))(q1, q2), msg=kind)
    pos = rng.uniform(-0.2, 0.2, (32, 5, 3)).astype(np.float32)
    goal = rng.uniform(-0.2, 0.2, (32, 5, 3)).astype(np.float32)
    gid = rng.integers(0, 2, (32, 5))
    active = np.arange(5) < 4
    np.testing.assert_array_equal(
        _np(t_goals.greedy_group_match(_t(pos), _t(goal), _t(gid), _t(active))),
        np.asarray(jax.vmap(lambda a, b, c: j_goals.greedy_group_match(a, b, c, active))(
            pos, goal, gid)))


def test_simulation_helpers_match_jax(port_env, jax_env, jax_reset):
    """The object accessors, set_object_poses, goal_qpos,
    check_objects_off_table, in_placement_area (two margins),
    gripper_table_contact, object_gripper_contact,
    geom_bbox_half and contact_wrench_on_geoms (gripper and objects, from
    the contact forces of a state after two main-sim substeps) on the reset
    states, 1e-5 abs and booleans exactly; and the goal's distances and
    relative goal."""
    from robogym_tpu.physics import step as j_step

    _, state, _ = jax_reset
    jm, m = jax_env.model, port_env.model
    jd = jax.jit(jax.vmap(lambda x: j_step.step_n(jm, x, 2)))(state.physics)
    d = _port_data(jd)
    idx, jidx = port_env.idx, jax_env.idx
    for name in ("object_positions", "object_quats", "object_velocities"):
        _close(getattr(t_sim, name)(idx, d), jax.vmap(lambda x: getattr(j_sim, name)(jidx, x))(jd))
    rng = np.random.default_rng(10)
    pos = rng.uniform(-0.6, 0.6, (B, O, 3)).astype(np.float32)
    pos[..., 2] = rng.uniform(0.2, 0.5, (B, O))
    quat = rng.standard_normal((B, O, 4)).astype(np.float32)
    got = t_sim.set_object_poses(idx, d, _t(pos), _t(quat))
    want = jax.vmap(lambda x, p, q: j_sim.set_object_poses(jidx, x, p, q))(jd, pos, quat)
    _close(got.qpos, want.qpos, 0)
    _close(got.qvel, want.qvel, 0)
    _close(t_sim.goal_qpos(idx, d, _t(pos), _t(quat)),
           jax.vmap(lambda x, p, q: j_sim.goal_qpos(jidx, x, p, q))(jd, pos, quat), 0)
    active = np.asarray([True, True, False])
    np.testing.assert_array_equal(
        _np(t_sim.check_objects_off_table(idx, _t(pos), active_mask=_t(active))),
        np.asarray(jax.vmap(lambda p: j_sim.check_objects_off_table(jidx, p, active_mask=active))(
            pos)))
    for margin in (0.02, 0.3):
        np.testing.assert_array_equal(
            _np(t_sim.in_placement_area(idx, _t(pos), 2, 1.0, margin, _t(active))),
            np.asarray(jax.vmap(lambda p: j_sim.in_placement_area(
                jidx, p, 2, 1.0, margin, active_mask=active))(pos)))
    np.testing.assert_array_equal(_np(t_sim.gripper_table_contact(idx, m, d)),
                                  np.asarray(jax.vmap(lambda x: j_sim.gripper_table_contact(
                                      jidx, jm, x))(jd)))
    np.testing.assert_array_equal(_np(t_sim.object_gripper_contact(idx, d)),
                                  np.asarray(jax.vmap(lambda x: j_sim.object_gripper_contact(
                                      jidx, x))(jd)))
    _close(t_sim.geom_bbox_half(m, idx.object_geom_ids),
           j_sim.geom_bbox_half(jm, jidx.object_geom_ids), 0)
    assert bool((d.efc_force_contact != 0).any())
    tcp = t_arm.tcp_xyz(port_env.robot.arm, d)
    for geoms in (idx.gripper_geom_ids, idx.object_geom_ids):
        got = t_sim.contact_wrench_on_geoms(geoms, tcp, m, d)
        want = jax.vmap(lambda x, r: j_sim.contact_wrench_on_geoms(geoms, r, jm, x))(
            jd, jnp.asarray(_np(tcp)))
        for g, w in zip(got, want):
            _close(g, w, 1e-5 * max(1.0, float(np.abs(np.asarray(w)).max())))
    act = jnp.asarray(np.arange(O) < 2)
    goal = {k: v for k, v in state.goal.items()}
    tgoal = {k: _t(v) for k, v in goal.items()}
    for name in ("goal_distance", "relative_goal"):
        got = getattr(port_env.goal_gen, name)(tgoal, d, _t(np.asarray(act)))
        want = jax.vmap(lambda g, x: getattr(jax_env.goal_gen, name)(g, x, act))(goal, jd)
        for k in got:
            _close(got[k], want[k], msg=f"{name} {k}")


# ---------------------------------------------------------------------------
# the env
# ---------------------------------------------------------------------------

def test_construction_matches_jax(port_env, jax_env):
    """The arm-to-tabletop settle (200 substeps at B=1, objects parked)
    against the JAX env's `_initial_data` within the env-step envelope,
    and the solver sim's initial state (the mocap on the TCP) 1e-5 abs."""
    td = bridge.data_to_numpy(port_env._initial_data)
    jd = {k: v[None] for k, v in bridge.data_to_numpy(jax_env._initial_data).items()}
    assert_physics_close(td, jd, _objects(port_env))
    ts = bridge.data_to_numpy(port_env._initial_solver_data)
    js = bridge.data_to_numpy(jax_env._initial_solver_data)
    for k in ("qpos", "mocap_pos", "mocap_quat", "xpos", "xquat"):
        _close(ts[k][0], js[k], msg=k)
    _close(port_env._initial_solver_data.mocap_pos[:, 0],
           port_env._initial_solver_data.xpos[:, port_env.solver_robot.arm.tcp_body_id], 0)


def test_reset_matches_jax(port_env, jax_env, jax_reset):
    """`reset` on the JAX keys' draws from the JAX env's settled initial
    state, against the JAX reset: the goal, the groups, the colours and the
    tracker exactly or 1e-6; the 40-substep object settle by the nudge rule
    over the whole batch (blocks dropped onto the table); the solver state
    1e-5; the obs of the calm envs within the envelope's tolerances."""
    keys, jstate, jobs = jax_reset
    base = port_env._initial_data
    port_env._initial_data = _port_data(jax_env._initial_data)
    port_env._initial_data = t_core.data_map(lambda x: x[None], port_env._initial_data)
    draws = jax_reset_draws(keys)
    try:
        tstate, tobs = port_env.reset(B, draws)

        def run(qvel):
            d0 = port_env._initial_data
            port_env._initial_data = d0.replace(qvel=qvel)
            try:
                return bridge.data_to_numpy(port_env.reset(B, draws)[0].physics)
            finally:
                port_env._initial_data = d0

        nudged = nudged_runs(run, port_env._initial_data.qvel)
    finally:
        port_env._initial_data = base
    td, jd = bridge.data_to_numpy(tstate.physics), bridge.data_to_numpy(jstate.physics)
    assert_physics_close(td, jd, _objects(port_env), nudged, whole=True)
    calm = _within_envelope(td, jd, port_env)
    for k, v in jstate.goal.items():
        _close(tstate.goal[k], v, 1e-6, msg=k)
    _close(tstate.model_fields["geom_rgba"], jstate.model_fields["geom_rgba"], 1e-6)
    for f in dataclasses.fields(t_core.TrackerState):
        np.testing.assert_array_equal(_np(getattr(tstate.tracker, f.name)),
                                      np.asarray(getattr(jstate.tracker, f.name)), err_msg=f.name)
    ts, js = bridge.data_to_numpy(tstate.goal_aux), bridge.data_to_numpy(jstate.goal_aux)
    for k in ("qpos", "mocap_pos", "mocap_quat"):
        _close(ts[k], js[k], msg=k)
    _compare_obs(tobs, jobs, calm)


def _obs_tol(k):
    if k in ("obj_vel_pos", "obj_vel_rot", "gripper_velp", "gripper_vel"):
        return QVEL_TOL
    if k in ("qpos", "qpos_goal", "robot_joint_pos", "gripper_qpos", "obj_rot", "obj_pos",
             "obj_rel_pos", "rel_goal_obj_pos", "rel_goal_obj_rot", "gripper_pos",
             "gripper_controls"):
        return QPOS_TOL
    return 1e-4


def _compare_obs(tobs, jobs, calm):
    assert sorted(tobs) == sorted(jobs) and calm.any()
    for k in tobs:
        t, j = _np(tobs[k]), np.asarray(jobs[k])
        assert t.shape == j.shape and np.isfinite(t).all(), k
        if k in ("tcp_force", "tcp_torque", "safety_stop", "obj_gripper_contact"):
            # contact forces: what the CG makes of the contacts, checked by
            # `test_simulation_helpers_match_jax` on one state
            continue
        _close(t[calm], j[calm], _obs_tol(k), msg=k)


def _within_envelope(td, jd, env):
    """(B,) the envs whose physics is within the env-step envelope of the
    reference in every group: those whose obs are compared."""
    calm = np.ones(td["qpos"].shape[0], bool)
    for _, field, cols, tol in _groups(_objects(env)):
        calm &= _env_err(td, jd, field, cols) <= tol
    return calm


def _compare_step(tout, jout, env, nudged=()):
    """Physics by the nudge rule over the whole batch (blocks settling on
    the table after the reset's drop are contact-rich: one env of
    `test_step_matches_jax`'s second step leaves the envelope by 4 % on a
    block's quaternion, 1.17 times its own largest nudged drift); on the
    envs within the envelope the obs; rewards, done, tracker and the info's
    integers and booleans exactly."""
    (ts, tobs, trew, tdone, tinfo), (js, jobs, jrew, jdone, jinfo) = tout, jout
    td, jd = bridge.data_to_numpy(ts.physics), bridge.data_to_numpy(js.physics)
    assert_physics_close(td, jd, _objects(env), [bridge.data_to_numpy(n[0].physics)
                                                 for n in nudged], whole=True)
    calm = _within_envelope(td, jd, env)
    _compare_obs(tobs, jobs, calm)
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
    np.testing.assert_array_equal(_np(ts.t), np.asarray(js.t))
    for k, v in js.goal.items():
        _close(ts.goal[k], v, 1e-6, msg=k)
    return calm


def _step_with_nudges(port_env, tstate, action, draws):
    """The port's step, and its runs from qvels nudged in both sims (the
    solver sim's joint response sets the main arm's targets)."""
    nv = tstate.physics.qvel.shape[1]

    def run(qvel):
        return port_env.step(tstate.replace(
            physics=tstate.physics.replace(qvel=qvel[:, :nv]),
            goal_aux=tstate.goal_aux.replace(qvel=qvel[:, nv:])), action, draws=draws)

    both = torch.cat([tstate.physics.qvel, tstate.goal_aux.qvel], dim=1)
    return port_env.step(tstate, action, draws=draws), nudged_runs(run, both)


def test_step_matches_jax(port_env, jax_reset, jax_step):
    """Two env steps at B=3, each from the JAX state carried across by the
    bridge, with the same actions (uniform in [-1, 1]) and the JAX keys'
    draws: physics, obs, rewards, done, info and tracker as
    `_compare_step` holds them."""
    _, jstate, _ = jax_reset
    rng = np.random.default_rng(11)
    for _ in range(2):
        action = rng.uniform(-1, 1, (B, 6)).astype(np.float32)
        tstate = _to_port(jstate)
        tout, nudged = _step_with_nudges(port_env, tstate, _t(action), jax_step_draws(jstate))
        jout = jax_step(jstate, jnp.asarray(action))
        _compare_step(tout, jout, port_env, nudged)
        jstate = jout[0]


def test_step_goal_resample_matches_jax(port_env, jax_reset, jax_step):
    """A step in which envs 0 and 2 resample their goal (a success held
    from an earlier step, `success_and_no_goal_reset`), on the JAX keys'
    draws: the new goals, the hold draws and everything `_compare_step`
    holds; env 1 keeps its goal."""
    _, jstate, _ = jax_reset
    jstate = jstate.replace(tracker=jstate.tracker.replace(
        success_and_no_goal_reset=jnp.asarray([True, False, True])))
    action = np.random.default_rng(12).uniform(-1, 1, (B, 6)).astype(np.float32)
    jout = jax_step(jstate, jnp.asarray(action))
    np.testing.assert_array_equal(np.asarray(jout[0].tracker.goals_so_far), [2, 1, 2])
    tout, nudged = _step_with_nudges(port_env, _to_port(jstate), _t(action),
                                     jax_step_draws(jstate))
    _compare_step(tout, jout, port_env, nudged)
    moved = np.abs(_np(tout[0].goal["obj_pos"]) - np.asarray(jstate.goal["obj_pos"])).max((1, 2))
    assert moved[0] > 0 and moved[1] == 0 and moved[2] > 0


def test_port_draws_run(port_env):
    """The port's own draws: a reset and a step at B=2 give finite obs and
    rewards, goals inside the placement area, each object's colour its
    group's, and parked inactive slots."""
    state, obs = port_env.reset(2)
    for k, v in obs.items():
        assert bool(torch.isfinite(v).all()), k
    assert bool(state.goal["goal_in_placement_area"].all())
    gid = state.goal["group_ids"]
    rgba = state.model_fields["geom_rgba"][:, torch.as_tensor(port_env.idx.object_geom_ids)]
    for b in range(2):
        for i in range(O):
            for j in range(O):
                if gid[b, i] == gid[b, j]:
                    assert torch.equal(rgba[b, i], rgba[b, j])
    assert bool((state.goal["obj_pos"][:, 2, 0] > 2.0).all())
    state, obs, reward, done, _ = port_env.step(state, torch.zeros((2, port_env.action_size)))
    assert bool(torch.isfinite(reward).all()) and all(bool(torch.isfinite(v).all())
                                                      for v in obs.values())


def test_env_state_round_trip_is_bit_equal(port_env, jax_reset):
    """The JAX reset state, with a regrasp state added, through the bridge
    to the port and back: every array bit-equal, the solver Data and the
    regrasp fields included."""
    _, jstate, _ = jax_reset
    arrays = bridge.env_state_to_numpy(jstate)
    tstate = bridge.env_state_from_numpy(arrays, "cpu")
    g = port_env.robot.gripper
    tstate = tstate.replace(robot_aux=t_grip.init_regrasp(
        tstate.physics.qpos[:, g.joint_qpos_id], tstate.physics.ctrl[:, g.actuator_id]))
    arrays = bridge.env_state_to_numpy(tstate)
    assert any(k.startswith("goal_aux.data.") for k in arrays)
    assert sum(k.startswith("robot_aux.") for k in arrays) == 7
    back = bridge.env_state_to_numpy(bridge.env_state_from_numpy(arrays, "cpu"))
    assert sorted(back) == sorted(arrays)
    for k in arrays:
        assert back[k].dtype == arrays[k].dtype and np.array_equal(back[k], arrays[k]), k
