"""The port's host-side drivers (`robogym_torch/robot/reach_helper.py`,
`teleop.py`, `parameter_manager.py`) and small utils (`utils/
parse_arguments.py`, `utils/testing.py`) against the JAX package's, on the
CPU.

`reach_position` drives the rearrange blocks env in JOINT control mode on
the UR16e-shaped stand-in (built for the JAX env by pointing
`simulation.build_blocks_world_xml` at `rearrange_blocks_like.write`, as
tests/test_torch_rearrange.py does; one block, two slots), from the JAX
env's reset state of two envs carried across, to targets 0.05 rad (env 0)
and 0.08 rad (env 1) from each env's arm pose: the JAX function runs each
env alone (its jitted single-env step), the port's both at once. Reached
flags and steps equal; final positions and errors to 1e-4 rad (a smooth
arm motion: the two packages' float32 rounding only).

Every teleop command's action vector and the speed changes, in the three
action layouts, exactly. `ShadowHandParameterManager` on the reach stand-in
(`dactyl_reach_like.npz`), with the four spring tendons and two coupling
pulleys given their reference names as aliases in both packages' models
(the stand-in names its tendons `robot0:T_<finger>J1c`): ids,
`current_parameters`, `parameter_bounds` and the fields that
`set_parameters` writes, field by field, to 1e-7. `parse_arguments` and
`assert_dict_match` on the same inputs give the same results."""

import dataclasses
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import jax_boxbox_kernel, snapshot_arrays
from robogym_torch import bridge
from robogym_torch.envs.rearrange import blocks as t_blocks
from robogym_torch.robot import parameter_manager as t_pm
from robogym_torch.robot import reach_helper as t_reach
from robogym_torch.robot import teleop as t_teleop
from robogym_torch.robot import ur16e as t_arm
from robogym_torch.utils import parse_arguments as t_args
from robogym_torch.utils import testing as t_testing
from robogym_torch.worlds import dactyl_reach_like, rearrange_blocks_like
from robogym_tpu.envs.rearrange import blocks as j_blocks
from robogym_tpu.envs.rearrange import simulation as j_sim
from robogym_tpu.robot import composite as j_comp
from robogym_tpu.robot import parameter_manager as j_pm
from robogym_tpu.robot import reach_helper as j_reach
from robogym_tpu.robot import teleop as j_teleop
from robogym_tpu.utils import parse_arguments as j_args
from robogym_tpu.utils import testing as j_testing

B = 2
CONSTANTS = {"stabilize_steps": 1}
PARAMETERS = {"simulation_params": {"num_objects": 1, "max_num_objects": 2},
              "robot_control_params": {"control_mode": "joint"}}
OFFSETS = (0.05, 0.08)   # rad, each env's target from its arm pose


@pytest.fixture(scope="module")
def jax_env(tmp_path_factory):
    """The JAX blocks env in joint mode on the stand-in world."""
    root = str(tmp_path_factory.mktemp("reach_helper"))

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


def test_reach_position_matches_jax(jax_env):
    """Both envs reach and stop; the same steps; the final positions and
    errors to 1e-4 rad; each env's returned state the state it reached
    in (its arm within the threshold and stopped)."""
    port_env = t_blocks.make_env(CONSTANTS, PARAMETERS, device="cpu", seed=0, worlds={
        "model": bridge.model_from_numpy(bridge.model_to_numpy(jax_env.model), "cpu")})
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    with jax_boxbox_kernel():
        jstate, _ = jax.jit(jax.vmap(jax_env.reset))(keys)
    state = bridge.env_state_from_numpy(bridge.env_state_to_numpy(jstate), "cpu")
    cur = t_arm.joint_positions(port_env.robot.arm, state.physics).double().numpy()
    target = cur + np.asarray(OFFSETS)[:, None]
    final, got = t_reach.reach_position(port_env, state, target, timeout_steps=40)
    for i in range(B):
        one = jax.tree_util.tree_map(lambda x: x[i], jstate)
        with jax_boxbox_kernel():
            _, want = j_reach.reach_position(jax_env, one, target[i], timeout_steps=40)
        assert bool(got.reached[i]) == want.reached
        assert int(got.steps[i]) == want.steps, (i, got.steps, want.steps)
        np.testing.assert_allclose(got.final_position[i], want.final_position, rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.final_error[i], want.final_error, rtol=0, atol=1e-4)
    assert got.reached.all() and got.reached_position_and_stopped().all()
    arm = t_arm.joint_positions(port_env.robot.arm, final.physics).double().numpy()
    np.testing.assert_array_equal(arm.astype(np.float32), got.final_position)
    vel = t_arm.joint_velocities(port_env.robot.arm, final.physics).numpy()
    assert (np.abs(vel) < np.deg2rad(1.0)).all()


@pytest.mark.parametrize("action_size", [5, 6, 7])
def test_teleop_actions_match_jax(action_size):
    """Every command of the keyboard map, the speed changes between them,
    and the tilt, in order, on both controllers."""
    env = types.SimpleNamespace(action_size=action_size)
    tc, jc = t_teleop.URGripperArmController(env), j_teleop.URGripperArmController(env)
    commands = list(j_teleop.URGripperArmController.KEYMAP) + ["+", "speed_up", "up", "-",
                                                               "speed_down", "grip+", "wrist-"]
    assert list(t_teleop.URGripperArmController.KEYMAP) == list(j_teleop.URGripperArmController.KEYMAP)
    for cmd in commands:
        np.testing.assert_array_equal(tc.action_for(cmd), jc.action_for(cmd), err_msg=cmd)
        assert (tc.arm_speed, tc.wrist_speed, tc.gripper_speed) == \
            (jc.arm_speed, jc.wrist_speed, jc.gripper_speed)
    for d in (t_teleop.Direction.POS, t_teleop.Direction.NEG):
        np.testing.assert_array_equal(tc.tilt_gripper(d), jc.tilt_gripper(d))
    np.testing.assert_array_equal(tc.zero_control(), jc.zero_control())


ALIASES = {"tendon": {f"robot0:{f}T2": f"robot0:T_{f}J1c" for f in ("FF", "MF", "RF", "LF")}}


def _aliased(const):
    """`const` with the reference's spring-tendon names and two coupling
    pulleys (FFJ1, MFJ0 on the first two geoms) added as aliases."""
    names = {k: dict(v) for k, v in const.names.items()}
    for kind, alias in ALIASES.items():
        for new, old in alias.items():
            names[kind][new] = names[kind][old]
    names["geom"]["robot0:coupling_FFJ1_pulley"] = 1
    names["geom"]["robot0:coupling_MFJ0_pulley"] = 2
    return dataclasses.replace(const, names=names)


@pytest.fixture(scope="module")
def hand_models():
    from _torch_common import jax_model_from_numpy

    arrays = snapshot_arrays(dactyl_reach_like.SNAPSHOT)
    tm = bridge.model_from_numpy(arrays, "cpu")
    jm = jax_model_from_numpy(arrays)
    return tm.replace(const=_aliased(tm.const)), jm.replace(const=_aliased(jm.const))


FIELDS = ("actuator_gainprm", "actuator_forcerange", "tendon_stiffness", "tendon_lengthspring",
          "tendon_range", "geom_size", "dof_damping", "jnt_range")


@pytest.mark.parametrize("actuator", ["A_FFJ1", "A_MFJ1", "A_THJ2", "A_WRJ0"])
def test_parameter_manager_matches_jax(hand_models, actuator):
    """Ids, current parameters, bounds, and a set of every key the actuator
    takes (each value scaled by 1.5, or +0.1 where it is 0): the written
    fields and the read-back parameters, field by field."""
    tm, jm = hand_models
    tp, jp = t_pm.ShadowHandParameterManager(tm), j_pm.ShadowHandParameterManager(jm)
    for attr in ("actuator_id", "joint_dof", "joint_id", "tendon_id", "pulley_geom"):
        assert getattr(tp, attr) == getattr(jp, attr), attr
    assert (actuator in tp.tendon_id) == t_pm.has_spring_tendon(actuator)
    cur = tp.current_parameters(tm, actuator)
    t_testing.assert_dict_match(cur, jp.current_parameters(jm, actuator), eps=1e-7)
    t_testing.assert_dict_match(tp.parameter_bounds(tm, actuator),
                                {k: v for k, v in jp.parameter_bounds(jm, actuator).items()},
                                eps=1e-7)
    new = {k: v * 1.5 if v else v + 0.1 for k, v in cur.items()}
    tm2, jm2 = tp.set_parameters(tm, actuator, new), jp.set_parameters(jm, actuator, new)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tm2, f).numpy(), np.asarray(getattr(jm2, f)),
                                   rtol=0, atol=1e-7, err_msg=f)
    t_testing.assert_dict_match(tp.current_parameters(tm2, actuator), new, eps=1e-6)
    assert not torch.equal(tm2.dof_damping, tm.dof_damping)
    # a per-env field is set in every env, and reading it asks for one env
    per_env = tm.replace(dof_damping=tm.dof_damping.expand(3, -1).clone(),
                         env_fields=frozenset({"dof_damping"}))
    out = tp.set_parameters(per_env, actuator, new)
    dof = tp.joint_dof[t_pm.ACTUATOR_JOINT_MAPPING[actuator][0]]
    key = t_pm.ACTUATOR_JOINT_MAPPING[actuator][0] + "_dof_damping"
    np.testing.assert_allclose(out.dof_damping[:, dof].numpy(), np.float32(new[key]))
    with pytest.raises(ValueError):
        tp.current_parameters(out, actuator)


def test_parse_arguments_and_assert_dict_match_match_jax():
    """The same names and kwargs from one argv (literals after `@`, ints,
    floats, booleans, strings); `assert_dict_match` passes and fails where
    the JAX one does, tensors compared as arrays."""
    argv = ["dactyl", "constants=@{'randomize': True, 'n': [1, 2]}", "seed=3", "lr=0.5",
            "flag=True", "name=locked", "other=false", "rearrange*"]
    assert t_args.parse_arguments(argv) == j_args.parse_arguments(argv)
    a = {"x": np.arange(3.0), "n": {"y": 1.0, "s": "a"}}
    b = {"x": torch.arange(3.0) + 1e-9, "n": {"y": 1.0, "s": "a"}}
    t_testing.assert_dict_match(a, b)
    j_testing.assert_dict_match(a, {"x": np.arange(3.0) + 1e-9, "n": {"y": 1.0, "s": "a"}})
    for bad in ({"x": torch.arange(3.0) + 1e-3, "n": {"y": 1.0, "s": "a"}},
                {"x": np.arange(3.0), "n": {"y": 1.0, "s": "b"}}, {"x": np.arange(3.0)}):
        with pytest.raises(AssertionError):
            t_testing.assert_dict_match(a, bad)
        with pytest.raises(AssertionError):
            j_testing.assert_dict_match(a, {k: np.asarray(v) if isinstance(v, torch.Tensor) else v
                                            for k, v in bad.items()})
