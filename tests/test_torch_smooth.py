"""The port's smooth phase and actuation against the JAX package, on the
worlds of tests/test_physics.py (written inline), a hinge chain with a
fixed tendon, a PID- and cascaded-PI-actuated hinge chain, a two-link arm
with a spatial tendon wrapped over a sphere, and the locked-like world.
Tolerance: 1e-5 abs in float32 (the two packages run the
same formulas; only the order of sums differs)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import BALL_BOX, locked_like_models, to_jax
from robogym_torch import bridge
from robogym_torch.mjcf.model import make_data
from robogym_torch.physics import actuation as t_act
from robogym_torch.physics import smooth as t_smooth
from robogym_tpu.mjcf.compiler import compile_xml
from robogym_tpu.physics import actuation as j_act
from robogym_tpu.physics import smooth as j_smooth

PENDULUM = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.001" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="pole" pos="0 0 1">
      <joint name="hinge" type="hinge" axis="0 1 0" pos="0 0 0" damping="0"/>
      <geom name="rod" type="capsule" fromto="0 0 0 0 0 -0.5" size="0.02"
            density="1000" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
</mujoco>
"""

LIMITED = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.001" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="pole" pos="0 0 1">
      <joint name="hinge" type="hinge" axis="0 1 0" pos="0 0 0" damping="0.01"
             limited="true" range="-0.3 0.3"/>
      <geom name="rod" type="capsule" fromto="0 0 0 0 0 -0.3" size="0.02"
            density="1000" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
</mujoco>
"""

CHAIN = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="l1" pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.2" stiffness="1" springref="0.1"/>
      <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.02" density="1000"/>
      <body name="l2" pos="0.2 0 0">
        <joint name="j2" type="hinge" axis="0 0 1" damping="0.1" limited="true" range="-1 1"/>
        <geom type="box" pos="0.1 0 0" size="0.1 0.02 0.02" density="800"/>
        <body name="l3" pos="0.2 0 0">
          <joint name="j3" type="hinge" axis="1 0 0" damping="0.05" frictionloss="0.01"/>
          <geom type="sphere" pos="0.05 0 0" size="0.03" density="500"/>
        </body>
      </body>
    </body>
  </worldbody>
  <tendon>
    <fixed name="t23"><joint joint="j2" coef="1"/><joint joint="j3" coef="0.5"/></fixed>
  </tendon>
  <actuator>
    <position name="p1" joint="j1" kp="3" ctrlrange="-1 1"/>
    <motor name="m2" joint="j2" gear="2"/>
    <position name="pt" tendon="t23" kp="1" ctrlrange="-0.5 0.5"/>
  </actuator>
</mujoco>
"""

PID_CHAIN = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="l1" pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.02" density="1000"/>
      <body name="l2" pos="0.2 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" fromto="0 0 0 0.15 0 0" size="0.02" density="1000"/>
      </body>
    </body>
  </worldbody>
  <actuator>
    <general name="pid" joint="j1" gaintype="user" biastype="user"
             gainprm="10 0.1 1 0.02 0.5 0.001"/>
    <general name="cas" joint="j2" gaintype="user" biastype="user" user="1"
             gainprm="5 0.2 0.5 0 0 2 0.1 0.3 0.6 3"/>
  </actuator>
</mujoco>
"""

SPATIAL = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <site name="anchor" pos="0 0.05 1.1"/>
    <body name="l1" pos="0 0 1">
      <joint name="j1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom type="capsule" fromto="0 0 0 0.2 0 0" size="0.02" density="1000"/>
      <geom name="wrap" type="sphere" pos="0.2 0 0" size="0.03" contype="0" conaffinity="0"/>
      <site name="side" pos="0.2 0 0.06"/>
      <site name="mid" pos="0.1 0 0.03"/>
      <body name="l2" pos="0.2 0 0">
        <joint name="j2" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom type="capsule" fromto="0 0 0 0.15 0 0" size="0.02" density="1000"/>
        <site name="tip" pos="0.15 0 0.02"/>
      </body>
    </body>
  </worldbody>
  <tendon>
    <spatial name="cable" stiffness="2" damping="0.1">
      <site site="anchor"/><site site="mid"/><geom geom="wrap" sidesite="side"/><site site="tip"/>
    </spatial>
  </tendon>
  <actuator>
    <motor name="pull" tendon="cable" gear="1"/>
  </actuator>
</mujoco>
"""

FIELDS = ("xpos", "xquat", "xmat", "xipos", "ximat", "geom_xpos", "geom_xmat", "subtree_com",
          "cdof", "cinert", "cvel", "qM", "qfrc_bias", "qfrc_passive", "qfrc_actuator",
          "actuator_length", "actuator_velocity", "actuator_force", "ten_length", "ten_J",
          "ten_velocity", "act", "act_dot")


def _jax_smooth(m):
    def f(d):
        d = j_smooth.kinematics(m, d)
        d = j_smooth.com_pos(m, d)
        d = j_smooth.crb(m, d)
        d = j_smooth.tendon(m, d)
        d, moment = j_smooth.transmission(m, d)
        d, cdofdot = j_smooth.com_vel(m, d)
        d = j_smooth.rne(m, d, cdofdot)
        d = j_act.actuation(m, d, moment)
        return j_smooth.passive(m, d)

    return jax.jit(jax.vmap(f))


def _torch_smooth(m, d):
    d = t_smooth.kinematics(m, d)
    d = t_smooth.com_pos(m, d)
    d = t_smooth.crb(m, d)
    d = t_smooth.tendon(m, d)
    d, moment = t_smooth.transmission(m, d)
    d, cdofdot = t_smooth.com_vel(m, d)
    d = t_smooth.rne(m, d, cdofdot)
    d = t_act.actuation(m, d, moment)
    return t_smooth.passive(m, d)


def _random_state(tm, batch, seed):
    """qpos near qpos0 (free-joint quaternions normalised), qvel, ctrl and
    act drawn from a numpy seed."""
    c = tm.const
    rng = np.random.default_rng(seed)
    qpos = np.tile(tm.qpos0.numpy(), (batch, 1))
    for j in range(c.njnt):
        a, jt = int(c.jnt_qposadr[j]), int(c.jnt_type[j])
        if jt in (2, 3):
            qpos[:, a] += 0.4 * rng.standard_normal(batch)
        else:
            lin = 3 if jt == 0 else 0
            qpos[:, a:a + lin] += 0.02 * rng.standard_normal((batch, lin))
            q = rng.standard_normal((batch, 4))
            qpos[:, a + lin:a + lin + 4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    d = make_data(tm, batch, torch.as_tensor(qpos.astype(np.float32)))
    f32 = lambda x: torch.as_tensor(x.astype(np.float32))
    return d.replace(qvel=f32(rng.standard_normal((batch, c.nv))),
                     ctrl=f32(rng.uniform(-1, 1, (batch, c.nu))),
                     act=f32(0.1 * rng.standard_normal((batch, c.na))))


def _compare(jmod, tm, d, atol=1e-5):
    jd = bridge.data_to_numpy(_jax_smooth(jmod)(to_jax(d)))
    td = bridge.data_to_numpy(_torch_smooth(tm, d))
    for k in FIELDS:
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=atol, err_msg=k)


@pytest.mark.parametrize("xml", [PENDULUM, LIMITED, BALL_BOX, CHAIN, PID_CHAIN, SPATIAL],
                         ids=["pendulum", "limited", "ball_box", "chain", "pid_chain", "spatial"])
def test_smooth_matches_jax_on_inline_worlds(xml):
    jmod = compile_xml(xml, dtype=jnp.float32)
    tm = bridge.model_from_numpy(bridge.model_to_numpy(jmod), "cpu")
    _compare(jmod, tm, _random_state(tm, 3, seed=len(xml)))


def test_smooth_matches_jax_on_locked_like():
    jmod, tm = locked_like_models()
    _compare(jmod, tm, _random_state(tm, 4, seed=5))


ROTATIONS = ["quat2mat", "quat_conjugate", "quat_mul", "quat_rot_vec", "quat_normalize",
             "quat_unit", "quat_from_angle_and_axis", "quat_integrate", "any_orthogonal"]


@pytest.mark.parametrize("name", ROTATIONS)
def test_rotation_matches_jax(name):
    """Each rotation function of the port against the JAX package's on 64
    seeded quaternions (some with w < 0, one zero angle), to 1e-6 abs in
    float32: the same formulas on unit-scale values."""
    from robogym_torch.utils import rotation as t_rot
    from robogym_tpu.utils import rotation as j_rot

    rng = np.random.default_rng(ROTATIONS.index(name))
    q = rng.standard_normal((64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, 64).astype(np.float32)
    omega = v.copy()
    omega[0] = 0.0
    args = {"quat2mat": (q,), "quat_conjugate": (q,), "quat_mul": (q, q[::-1].copy()),
            "quat_rot_vec": (q, v), "quat_normalize": (q,), "quat_unit": (3.0 * q,),
            "quat_from_angle_and_axis": (angle, v), "quat_integrate": (q, omega, 0.002),
            "any_orthogonal": (v,)}[name]
    want = getattr(j_rot, name)(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                  for a in args])
    got = getattr(t_rot, name)(*[torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                                 for a in args])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
