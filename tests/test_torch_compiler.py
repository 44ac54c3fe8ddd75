"""The port's MJCF compiler against the JAX package's, and the port's
compile of every stand-in world against its committed snapshot.

Both compilers build each field in float64 and cast it once to float32, so
the port's model equals the JAX model field by field, exactly, with the
names and the stashed source XML. The JAX side runs with
`dtype=jnp.float32` on the CPU.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import BALL_BOX
from robogym_torch import bridge
from robogym_torch.mjcf import compiler as t_compiler
from robogym_torch.mjcf import modifiers as t_modifiers
from robogym_torch.mjcf import xml_tools as t_xml
from robogym_torch.mjcf.model import GeomType
from robogym_torch.physics import setconst as t_setconst
from robogym_torch.worlds import locked_like
from robogym_torch.worlds.compile import WORLDS, compile_world, snapshot_path
from robogym_tpu.mjcf import compiler as j_compiler
from robogym_tpu.mjcf import modifiers as j_modifiers
from robogym_tpu.mjcf import xml_tools as j_xml

HERE = os.path.dirname(os.path.abspath(__file__))

PENDULUM = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.001" gravity="0 0 -9.81"/>
  <worldbody>
    <body name="pole" pos="0 0 1">
      <joint name="hinge" type="hinge" axis="0 1 0" pos="0 0 0" damping="0.01"
             limited="true" range="-0.3 0.3"/>
      <geom name="rod" type="capsule" fromto="0 0 0 0 0 -0.5" size="0.02"
            density="1000" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
</mujoco>
"""

# tests/test_torch_equality.py's world: weld, connect and joint equalities
# (with and without joint2), a mocap body, contact excludes
EQUALITY = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1" pos="0 0 0"/>
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

# every tag of the compiler's subset: defaults with class inheritance
# (childclass, nested classes, per-tag defaults), an include, STL meshes
# (named and unnamed, scaled), fixed and spatial tendons, general (PID and
# affine), position, motor and velocity actuators, weld (with relpose,
# inactive), connect and joint equalities, contact pair and exclude, a
# camera, a light and material rgba; ball, slide, hinge and free joints, a
# mocap body, full and diagonal inertias, every orientation form
RICH = """
<mujoco>
  <compiler angle="degree" meshdir="{meshdir}"/>
  <option timestep="0.003" gravity="0 0 -9.8" impratio="2" iterations="40" cg_iterations="20"/>
  <default>
    <joint damping="0.1" armature="0.01"/>
    <geom friction="0.8 0.01 0.001" solref="0.01 1" solimp="0.9 0.95 0.001"/>
    <position kp="5" ctrlrange="-1 1" ctrllimited="true"/>
    <default class="finger">
      <joint range="-30 60" frictionloss="0.02" margin="1"/>
      <geom type="capsule" size="0.008" condim="4" rgba="0.2 0.3 0.4 1"/>
      <default class="tip">
        <geom type="mesh" mesh="prism" density="700"/>
        <site size="0.004"/>
      </default>
    </default>
  </default>
  <asset>
    <material name="red" rgba="0.9 0.1 0.1 1"/>
    <mesh name="prism" file="prism.stl" scale="1 1.2 0.9"/>
    <mesh file="palm.stl"/>
  </asset>
  <worldbody>
    <light name="sun" directional="true" pos="0 0 3" dir="0 0 -1" diffuse="0.8 0.7 0.6"
           ambient="0.1 0.2 0.3"/>
    <light name="lamp" pos="0.2 0 1" active="false"/>
    <camera name="cam0" pos="0.5 -0.5 0.6" euler="45 0 30" fovy="50"/>
    <geom name="floor" type="plane" size="1 1 0.1" material="red"/>
    <body name="base" pos="0 0 0.3" euler="0 0 30">
      <geom name="palm" type="mesh" mesh="palm"/>
      <site name="s_base" pos="0.01 0 0.02"/>
      <camera name="cam1" pos="0 0 0.2" quat="0 1 0 0"/>
      <body name="f1" childclass="finger" pos="0.02 0 0.05" axisangle="0 1 0 15">
        <joint name="f1_j1" axis="0 1 0"/>
        <joint name="f1_j2" axis="1 0.01 0"/>
        <geom name="f1_link" fromto="0 0 0 0 0 0.04"/>
        <site name="s_f1" pos="0 0.01 0.03"/>
        <body name="f1_tip" pos="0 0 0.04">
          <joint name="f1_j3" axis="0 1 0" stiffness="0.5" springref="10"/>
          <geom name="f1_tipg" class="tip"/>
          <site name="s_tip" class="tip" pos="0 0 0.01"/>
        </body>
      </body>
      <body name="f2" childclass="finger" pos="-0.02 0 0.05" zaxis="0.1 0 1">
        <joint name="f2_j1" type="slide" axis="0 0 1" range="-0.01 0.02"/>
        <geom name="f2_link" type="box" size="0.01 0.01 0.02" material="red"/>
        <inertial pos="0 0 0.01" mass="0.05" fullinertia="1e-5 2e-5 1.5e-5 1e-6 0 2e-7"/>
      </body>
    </body>
    <body name="ball" pos="0.1 0.05 0.5">
      <joint name="ball_j" type="ball" limited="true" range="0 45"/>
      <geom name="ball_g" type="ellipsoid" size="0.02 0.03 0.025" rgba="0 1 0 1"/>
      <inertial pos="0 0 0" mass="0.1" diaginertia="1e-4 2e-4 3e-4" quat="0.9 0.1 0 0.1"/>
    </body>
    <body name="cyl" pos="-0.1 0 0.5">
      <freejoint/>
      <geom name="cyl_g" type="cylinder" size="0.02 0.03"/>
      <geom name="cyl_s" type="sphere" size="0.015" pos="0 0 0.03" mass="0.02"/>
    </body>
    <body name="target" mocap="true" pos="0 0 0.8"/>
    <include file="inc.xml"/>
  </worldbody>
  <tendon>
    <fixed name="t_fixed" limited="true" range="-0.5 0.5">
      <joint joint="f1_j1" coef="1"/>
      <joint joint="f1_j3" coef="-0.5"/>
    </fixed>
    <spatial name="t_spatial" stiffness="10" damping="0.1">
      <site site="s_base"/>
      <site site="s_f1"/>
      <site site="s_tip"/>
    </spatial>
  </tendon>
  <actuator>
    <general name="a_pid" joint="f1_j1" gaintype="user" biastype="user" gainprm="1 0.1 0.01"
             user="1" ctrlrange="-2 2"/>
    <general name="a_affine" tendon="t_fixed" gainprm="3" biasprm="0 -3 -0.1"
             forcerange="-1 1" gear="2"/>
    <position name="a_pos" joint="f2_j1"/>
    <motor name="a_motor" joint="f1_j3" gear="0.5" forcelimited="true" forcerange="-0.2 0.2"/>
    <velocity name="a_vel" joint="f1_j2" kv="0.3"/>
  </actuator>
  <equality>
    <weld name="w" body1="target" body2="cyl" relpose="0 0 0.1 1 0 0 0"/>
    <weld name="w2" body1="ball" solref="0.05 1" active="false"/>
    <connect name="c" body1="f2" body2="ball" anchor="0 0 0.02"/>
    <joint name="jj" joint1="f1_j2" joint2="f1_j1" polycoef="0 0.5 0 0 0"/>
    <joint name="j1" joint1="f2_j1" polycoef="0.01 0 0 0 0"/>
  </equality>
  <contact>
    <exclude body1="f1" body2="f2"/>
    <pair geom1="ball_g" geom2="cyl_g"/>
  </contact>
</mujoco>
"""

INCLUDE = """
<mujocoinclude>
  <body name="inc_body" pos="0.3 0 0.2">
    <freejoint name="inc_j"/>
    <geom name="inc_box" type="box" size="0.02 0.03 0.01" rgba="0.5 0.5 0 1"/>
  </body>
</mujocoinclude>
"""

# a box, a cylinder, an ellipsoid and a mesh, each free, over a plane: the
# pairs box-cylinder, box-ellipsoid, mesh-cylinder and mesh-ellipsoid are
# keyed the other way round in the pair table (ROADMAP section 3, item 5)
PAIR_FAULT = """
<mujoco>
  <compiler angle="radian" meshdir="{meshdir}"/>
  <asset><mesh name="prism" file="prism.stl"/></asset>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1"/>
    <body name="box" pos="0 0 0.1"><freejoint/><geom name="box" type="box" size="0.02 0.02 0.02"/></body>
    <body name="cyl" pos="0.1 0 0.1"><freejoint/><geom name="cyl" type="cylinder" size="0.02 0.02"/></body>
    <body name="ell" pos="0.2 0 0.1"><freejoint/><geom name="ell" type="ellipsoid" size="0.02 0.03 0.01"/></body>
    <body name="mesh" pos="0.3 0 0.1"><freejoint/><geom name="mesh" type="mesh" mesh="prism"/></body>
  </worldbody>
</mujoco>
"""


def _write_assets(directory: str) -> None:
    with open(os.path.join(directory, "prism.stl"), "w") as f:
        f.write(locked_like._stl(locked_like._prism(0.03, 0.01, "x")))
    with open(os.path.join(directory, "palm.stl"), "w") as f:
        f.write(locked_like._stl(locked_like._palm()))
    with open(os.path.join(directory, "inc.xml"), "w") as f:
        f.write(INCLUDE)


def _assert_same(a, b):
    assert sorted(a) == sorted(b), set(a) ^ set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x, y), k


def _both(src: str, tmp: str):
    """(JAX model, port model) of the document `src`, each package's
    `MjcfXML` reading it with `tmp` as its base directory."""
    jm = j_compiler.compile_xml(j_xml.MjcfXML.from_string(src, base_dir=tmp), dtype=jnp.float32)
    tm = t_compiler.compile_xml(t_xml.MjcfXML.from_string(src, base_dir=tmp), device="cpu")
    return jm, tm


@pytest.mark.parametrize("doc", ["pendulum", "ball_box", "equality", "rich"])
def test_compile_xml_matches_the_jax_compiler(doc):
    """Every field, the names and the stashed source XML of the port's
    compile equal the JAX compiler's, exactly."""
    with tempfile.TemporaryDirectory() as tmp:
        _write_assets(tmp)
        src = {"pendulum": PENDULUM, "ball_box": BALL_BOX, "equality": EQUALITY,
               "rich": RICH.format(meshdir=tmp)}[doc]
        jm, tm = _both(src, tmp)
    _assert_same(bridge.model_to_numpy(tm), bridge.model_to_numpy(jm))
    assert tm.const._source_xml == jm.const._source_xml
    assert tm.device == torch.device("cpu") and tm.dtype == torch.float32
    if doc == "rich":
        c = tm.const
        assert (c.nmesh, c.ntendon, c.nu, c.neq, c.ncam, c.nlight, c.nmocap) == (2, 2, 5, 5, 2, 2, 1)
        assert "inc_box" in c.names["geom"] and tm.opt.cg_iterations == 20


def test_compile_xml_in_float64():
    """The port's float64 compile equals the JAX compiler's float64 one."""
    with tempfile.TemporaryDirectory() as tmp:
        _write_assets(tmp)
        src = RICH.format(meshdir=tmp)
        jm = j_compiler.compile_xml(j_xml.MjcfXML.from_string(src, base_dir=tmp),
                                    dtype=jnp.float64)
        tm = t_compiler.compile_xml(t_xml.MjcfXML.from_string(src, base_dir=tmp),
                                    dtype=torch.float64, device="cpu")
    _assert_same(bridge.model_to_numpy(tm), bridge.model_to_numpy(jm))


def test_pair_table_fault_is_repeated():
    """Both compilers look a pair up by its types in ascending order in a
    table keyed the other way round for four pairs, so both make no
    box-cylinder, box-ellipsoid, mesh-cylinder or mesh-ellipsoid pair."""
    with tempfile.TemporaryDirectory() as tmp:
        _write_assets(tmp)
        jm, tm = _both(PAIR_FAULT.format(meshdir=tmp), tmp)
    pairs = np.asarray(tm.const.collision_pairs)
    np.testing.assert_array_equal(pairs, np.asarray(jm.const.collision_pairs))
    types = {tuple(sorted(np.asarray(tm.const.geom_type)[p].tolist())) for p in pairs}
    for dropped in ((GeomType.CYLINDER, GeomType.BOX), (GeomType.ELLIPSOID, GeomType.BOX),
                    (GeomType.CYLINDER, GeomType.MESH), (GeomType.ELLIPSOID, GeomType.MESH)):
        assert dropped not in types
    assert (GeomType.BOX, GeomType.MESH) in types and (GeomType.PLANE, GeomType.CYLINDER) in types


@pytest.mark.parametrize("world", WORLDS)
def test_compile_world_matches_its_snapshot(world):
    """The port's own compile of each stand-in world equals the snapshot
    the JAX compiler wrote, field by field, exactly; so do the diagApprox
    weights it warms."""
    model = compile_world(world, "cpu")
    with np.load(snapshot_path(world)) as z:
        arrays = {k: z[k] for k in z.files}
    _assert_same(bridge.model_to_numpy(model), arrays)
    loaded = bridge.model_from_numpy(arrays, "cpu")
    for got, want in zip(t_setconst.invweight0(model), t_setconst.compute_invweight0(loaded)):
        np.testing.assert_array_equal(got, want)
    assert "<mujoco" in model.const._source_xml


def _modifier_models():
    jm = j_compiler.compile_xml(EQUALITY, dtype=jnp.float32)
    return jm, t_compiler.compile_xml(EQUALITY, device="cpu")


def test_modifiers_match_the_jax_package():
    """Timestep and field-row modifiers, set and scale, through
    `apply_modifiers` (a parameter it lacks skipped), on both packages'
    models of one world."""
    jm, tm = _modifier_models()
    names = ["hand", "tip"]

    def mods(lib):
        return [("sim_timestep", lib.TimestepModifier()),
                ("size_scale", lib.FieldRowsModifier("geom_size", "geom", names)),
                ("mass", lib.FieldRowsModifier("body_mass", "body", ["bob"], mode="set")),
                ("missing", lib.TimestepModifier())]

    params = {"sim_timestep": 0.004, "size_scale": np.array([1.5, 0.5, 2.0], np.float32),
              "mass": 0.25}
    j_out = j_modifiers.apply_modifiers(jm, mods(j_modifiers), params)
    t_out = t_modifiers.apply_modifiers(tm, mods(t_modifiers), params)
    _assert_same(bridge.model_to_numpy(t_out), bridge.model_to_numpy(j_out))
    assert not t_out.env_fields


def test_per_env_modifier_values_ride_model_fields():
    """A value with a leading env axis makes the field each env's own,
    equal to the JAX modifier under `jax.vmap` over that axis."""
    jm, tm = _modifier_models()
    rng = np.random.default_rng(0)
    scale = rng.uniform(0.5, 1.5, (3, 2, 3)).astype(np.float32)
    ts = np.array([0.001, 0.002, 0.004], np.float32)
    j_mod = j_modifiers.FieldRowsModifier("geom_size", "geom", ["hand", "tip"])
    t_mod = t_modifiers.FieldRowsModifier("geom_size", "geom", ["hand", "tip"])
    want = jax.vmap(lambda v: j_mod(jm, v).geom_size)(jnp.asarray(scale))
    got = t_mod(tm, scale)
    assert "geom_size" in got.env_fields
    np.testing.assert_array_equal(got.geom_size.numpy(), np.asarray(want))
    want_ts = jax.vmap(lambda v: j_modifiers.TimestepModifier()(jm, v).opt.timestep)(
        jnp.asarray(ts))
    got_ts = t_modifiers.TimestepModifier()(got, ts)
    assert "opt:timestep" in got_ts.env_fields
    np.testing.assert_array_equal(got_ts.opt.timestep.numpy(), np.asarray(want_ts))
    # a second per-env scale multiplies each env's own rows
    twice = t_mod(got, scale)
    np.testing.assert_array_equal(
        twice.geom_size.numpy(),
        np.asarray(jax.vmap(lambda v: j_mod(j_mod(jm, v), v).geom_size)(jnp.asarray(scale))))
