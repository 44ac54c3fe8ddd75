"""Equality constraints in the port against the JAX package, on an inline
world with one of each row type the JAX package builds: a `weld` of a free
box to a mocap body, a `connect` of a free bob to the tip of a two-hinge
arm, a `joint` equality with `joint2` (a polynomial of the arm's second
hinge drives the third) and one without (the first hinge held at a
constant).

Checked: `constraint.scalar_blocks` (rows, pos, diagA and kind; the rows
and pos within 1e-5 abs, diagA within 1e-5 relative to its largest entry,
as test_torch_joints.py holds `invweight0`: both invert the same float32 M
in float64), 10 substeps of `step_n` and one `forward()`, with the floor's
contact slots (the fused core, kernel B's plain version) and without them
(`make_efc` and kernel F's plain version): after the substeps, qpos and
qvel within the 1e-4 abs of tests/test_torch_step.py; after `forward()`,
qacc and qfrc_constraint within 1e-3 of their largest magnitude, the
tolerance tests/test_torch_forward.py holds forward()'s qacc to on worlds
with contact slots (each package runs its own smooth phase, and the
unconverged CG amplifies their last-bit differences; here qacc reaches
1000, a stiff weld)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import to_jax
from robogym_torch import bridge
from robogym_torch.mjcf.model import make_data
from robogym_torch.physics import constraint as t_constraint
from robogym_torch.physics import step as t_step
from robogym_tpu.mjcf.compiler import compile_xml
from robogym_tpu.physics import constraint as j_constraint
from robogym_tpu.physics import step as j_step

B = 4

EQUALITY = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1" pos="0 0 0"{floor}/>
    <body name="target" mocap="true" pos="0.3 0 0.3"/>
    <body name="hand" pos="0.3 0 0.3">
      <freejoint name="hand_j"/>
      <geom name="hand" type="box" size="0.03 0.02 0.01" density="1000"/>
    </body>
    <body name="arm" pos="-0.2 0 0.4">
      <joint name="a1" type="hinge" axis="0 1 0" damping="0.1"/>
      <geom name="arm" type="capsule" fromto="0 0 0 0.15 0 0" size="0.01"/>
      <body name="fore" pos="0.15 0 0">
        <joint name="a2" type="hinge" axis="0 1 0" damping="0.1"/>
        <geom name="fore" type="capsule" fromto="0 0 0 0.12 0 0" size="0.01"/>
        <body name="tip" pos="0.12 0 0">
          <joint name="a3" type="hinge" axis="0 0 1" damping="0.05"/>
          <geom name="tip" type="box" size="0.01 0.02 0.005" density="800"/>
        </body>
      </body>
    </body>
    <body name="bob" pos="0.07 0 0.4">
      <freejoint name="bob_j"/>
      <geom name="bob" type="sphere" size="0.02" density="1000" pos="0 0 -0.03"/>
    </body>
  </worldbody>
  <contact>
    <exclude body1="tip" body2="bob"/>
    <exclude body1="fore" body2="bob"/>
  </contact>
  <equality>
    <weld name="grab" body1="target" body2="hand"/>
    <connect name="hang" body1="fore" body2="bob" anchor="0.12 0 0"/>
    <joint name="couple" joint1="a3" joint2="a2" polycoef="0 0.5 0.3 0 0"/>
    <joint name="hold" joint1="a1" polycoef="0.1 0 0 0 0" solref="0.05 1"/>
  </equality>
</mujoco>
"""


def _models(floor: bool):
    xml = EQUALITY.format(floor="" if floor else ' contype="0" conaffinity="0"')
    jmod = compile_xml(xml, dtype=jnp.float32)
    return jmod, bridge.model_from_numpy(bridge.model_to_numpy(jmod), "cpu")


@pytest.fixture(scope="module")
def worlds():
    return {floor: _models(floor) for floor in (True, False)}


def _state(tm, seed):
    """Hinges and the bob off their equalities' targets, the mocap moved
    and turned away from the hand, seeded qvel: every row's error is
    nonzero."""
    c = tm.const
    rng = np.random.default_rng(seed)
    qpos = np.tile(tm.qpos0.numpy().astype(np.float64), (B, 1))
    jn = c.names["joint"]
    for j in ("a1", "a2", "a3"):
        qpos[:, c.jnt_qposadr[jn[j]]] = rng.uniform(-0.3, 0.3, B)
    a = c.jnt_qposadr[jn["bob_j"]]
    qpos[:, a:a + 3] += rng.uniform(-0.01, 0.01, (B, 3))
    mocap_pos = np.asarray([[0.3, 0.0, 0.3]]) + rng.uniform(-0.02, 0.02, (B, 3))
    q = np.concatenate([np.ones((B, 1)), 0.1 * rng.standard_normal((B, 3))], 1)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    d = make_data(tm, B, f32(qpos)).replace(
        qvel=f32(0.2 * rng.standard_normal((B, c.nv))),
        mocap_pos=f32(mocap_pos[:, None]),
        mocap_quat=f32((q / np.linalg.norm(q, axis=1, keepdims=True))[:, None]))
    return d


def test_world_has_every_equality_type(worlds):
    from robogym_torch.mjcf.model import EqType

    c = worlds[True][1].const
    assert sorted(int(t) for t in c.eq_type) == sorted(
        [EqType.WELD, EqType.CONNECT, EqType.JOINT, EqType.JOINT])
    assert c.nmocap == 1 and int(c.eq_obj2id[2]) > 0 and int(c.eq_obj2id[3]) == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_scalar_blocks_match_jax(worlds, seed):
    """The port's `scalar_blocks` against the JAX one per env on the same
    positioned state: the 11 equality rows first (6 weld, 3 connect, 2
    joint), kind EQ, then the rest."""
    jmod, tm = worlds[True]
    d = t_step.fwd_position(tm, _state(tm, seed))
    J, pos, solref, solimp, floss, active, kind, diagA = t_constraint.scalar_blocks(tm, d)
    jd = to_jax(d)
    assert kind[:11].tolist() == [t_constraint.EQ] * 11
    for b in range(B):
        want = j_constraint.scalar_blocks(jmod, jax.tree.map(lambda x: x[b], jd))
        np.testing.assert_allclose(J[b].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
        np.testing.assert_allclose(pos[b].numpy(), np.asarray(want[1]), rtol=0, atol=1e-5)
        for got, w in ((solref, want[2]), (solimp, want[3]), (floss, want[4])):
            np.testing.assert_array_equal(got[b].numpy(), np.asarray(w))
        np.testing.assert_array_equal(active[b].numpy(), np.asarray(want[5]))
        np.testing.assert_array_equal(kind, want[6])
        np.testing.assert_allclose(diagA, want[7], rtol=0, atol=1e-5 * np.abs(want[7]).max())
    assert np.abs(pos.numpy()[:, :11]).min(0).max() > 1e-4


@pytest.mark.parametrize("floor", [True, False])
def test_step_n_and_forward_match_jax(worlds, floor):
    """10 substeps of `step_n` and one `forward()` from the same state,
    against the JAX package's (vmapped, jitted): after the substeps qpos and
    qvel within 1e-4 abs, after `forward()` qacc and qfrc_constraint within
    1e-3 of their largest magnitude."""
    jmod, tm = worlds[floor]
    d = _state(tm, 2)
    td = bridge.data_to_numpy(t_step.step_n(tm, d, 10))
    jd = bridge.data_to_numpy(jax.jit(jax.vmap(lambda x: j_step.step_n(jmod, x, 10)))(to_jax(d)))
    for k in ("qpos", "qvel"):
        assert np.isfinite(td[k]).all()
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=1e-4, err_msg=k)
    tf = bridge.data_to_numpy(t_step.forward(tm, d))
    jf = bridge.data_to_numpy(jax.jit(jax.vmap(lambda x: j_step.forward(jmod, x)))(to_jax(d)))
    for k in ("qacc", "qfrc_constraint"):
        np.testing.assert_allclose(tf[k], jf[k], rtol=0, atol=1e-3 * np.abs(jf[k]).max(),
                                   err_msg=k)
    # the equalities pull: the constraint force is not zero
    assert np.abs(tf["qfrc_constraint"]).max() > 1e-3
