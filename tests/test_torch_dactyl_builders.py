"""The port's dactyl world builders against the JAX package's, on the CPU,
on one stand-in asset tree (`robogym_torch/worlds/dactyl_assets_like.py`)
that both packages' `xml_tools` read for the whole module.

Each builder (the cube world, with and without the vision cameras, the
face, full and reach worlds) gives the JAX builder's XML string; the port's
compiler gives the JAX compiler's fields (`dtype=jnp.float32`), exactly;
the objects the builders remove are in the tree and not in the worlds;
the committed composed snapshots are the JAX compiles. The locked and
reach envs on their composed worlds are held to the JAX envs that the JAX
constructors compose from the same tree, by the checks of
tests/test_torch_env.py and tests/test_torch_reach.py (called with this
module's envs): the settle, the reset and the steps, physics by the nudge
rule of `_torch_common.assert_physics_close`. The face and full envs are
held at the compile level, and by one construction, reset and step of the
port alone at B=2."""

import copy
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_env as tenv
import test_torch_reach as treach
from _torch_common import jax_boxbox_kernel
from robogym_torch import bridge
from robogym_torch.envs.dactyl import cube_env as t_cube
from robogym_torch.envs.dactyl import face_perpendicular as t_face
from robogym_torch.envs.dactyl import full_perpendicular as t_full
from robogym_torch.envs.dactyl import locked as t_locked
from robogym_torch.envs.dactyl import reach as t_reach
from robogym_torch.mjcf import compiler as t_compiler
from robogym_torch.mjcf import xml_tools as t_xml
from robogym_torch.worlds import dactyl_assets_like
from robogym_torch.worlds import compile as t_worlds
from robogym_tpu.envs.dactyl import cube_env as j_cube
from robogym_tpu.envs.dactyl import face_perpendicular as j_face
from robogym_tpu.envs.dactyl import full_perpendicular as j_full
from robogym_tpu.envs.dactyl import locked as j_locked
from robogym_tpu.envs.dactyl import reach as j_reach
from robogym_tpu.mjcf import compiler as j_compiler
from robogym_tpu.mjcf import xml_tools as j_xml

B = 4

# world -> (the port's builder, the JAX builder)
BUILDERS = {
    "dactyl_locked_composed": (lambda: t_cube.build_cube_world_xml(t_cube.CubeEnvBase.CUBE_XML),
                               lambda: j_cube.build_cube_world_xml(j_cube.CubeEnvBase.CUBE_XML)),
    "dactyl_locked_vision": (
        lambda: t_cube.build_cube_world_xml(t_cube.CubeEnvBase.CUBE_XML, with_vision_cams=True),
        lambda: j_cube.build_cube_world_xml(j_cube.CubeEnvBase.CUBE_XML, with_vision_cams=True)),
    "rubik_face_composed": (t_face.build_face_world_xml, j_face.build_face_world_xml),
    "rubik_full_composed": (t_full.build_full_world_xml, j_full.build_full_world_xml),
    "dactyl_reach_composed": (t_reach.build_reach_xml, j_reach.build_reach_xml),
}


@pytest.fixture(scope="module", autouse=True)
def tree():
    """The stand-in asset tree, which both packages read while this module
    runs (the JAX package fixes its directories at import: its module's
    `ASSETS_DIR` / `XML_DIR` and `MjcfXML.meshdir` / `texturedir` are
    pointed at the tree)."""
    cls = j_xml.MjcfXML
    saved = (t_xml.ASSETS_DIR, t_xml.XML_DIR, j_xml.ASSETS_DIR, j_xml.XML_DIR, cls.meshdir,
             cls.texturedir)
    with tempfile.TemporaryDirectory() as tmp:
        files = dactyl_assets_like.write_assets(tmp)
        xml_dir = os.path.join(tmp, "xmls")
        t_xml.ASSETS_DIR, t_xml.XML_DIR = tmp, xml_dir
        j_xml.ASSETS_DIR, j_xml.XML_DIR = tmp, xml_dir
        cls.meshdir, cls.texturedir = os.path.join(tmp, "stls"), os.path.join(tmp, "textures")
        try:
            yield files
        finally:
            (t_xml.ASSETS_DIR, t_xml.XML_DIR, j_xml.ASSETS_DIR, j_xml.XML_DIR, cls.meshdir,
             cls.texturedir) = saved


def _assert_same(a, b):
    assert sorted(a) == sorted(b), set(a) ^ set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x, y), k


@pytest.mark.parametrize("world", sorted(BUILDERS))
def test_builder_gives_the_jax_xml(world):
    port, jax_builder = BUILDERS[world]
    assert port().xml_string() == jax_builder().xml_string()


@pytest.mark.parametrize("world", sorted(BUILDERS))
def test_compile_matches_the_jax_compiler(world):
    """The port's compile of each composed document equals the JAX
    compiler's field by field, with the names and the source XML; the
    committed snapshot of each composed world is the JAX compile."""
    port, jax_builder = BUILDERS[world]
    jm = j_compiler.compile_xml(jax_builder(), dtype=jnp.float32)
    tm = t_compiler.compile_xml(port(), device="cpu")
    want = bridge.model_to_numpy(jm)
    _assert_same(bridge.model_to_numpy(tm), want)
    assert tm.const._source_xml == jm.const._source_xml
    if world in t_worlds.COMPOSED:
        with np.load(t_worlds.snapshot_path(world)) as z:
            _assert_same({k: z[k] for k in z.files}, want)


def test_compile_world_entry_points(tree):
    """Each env module's `compile_world` on the CPU equals the world
    `worlds.compile.compile_world` builds on its own temporary tree; the
    cube world takes the vision cameras exactly where the constants ask
    for raycast images."""
    for world, fn in (("dactyl_locked_composed",
                       lambda: t_cube.compile_world(t_locked.LockedEnvConstants(), "cpu")),
                      ("rubik_face_composed", lambda: t_face.compile_world(None, "cpu")),
                      ("rubik_full_composed", lambda: t_full.compile_world(None, "cpu")),
                      ("dactyl_reach_composed", lambda: t_reach.compile_world(None, "cpu"))):
        _assert_same(bridge.model_to_numpy(fn()),
                     bridge.model_to_numpy(t_worlds.compile_world(world, "cpu")))
    cams = t_cube.compile_world(
        t_locked.LockedEnvConstants(vision_observation_provider="raycast"), "cpu")
    assert sorted(cams.const.names["camera"]) == ["vision_cam_left", "vision_cam_right",
                                                  "vision_cam_top"]
    assert t_cube.compile_world(
        t_locked.LockedEnvConstants(vision_observation_provider="dummy_vision"),
        "cpu").const.ncam == 0


def _names(model):
    return {n for table in model.const.names.values() for n in table}


def test_removed_objects(tree):
    """The objects the builders remove are real objects of the tree (a
    geom, a site or a joint) and are in no composed world: the hand's base
    and outer bound, the locked cube's outer bound (in the cube and the
    target), the perpendicular cube's spring hinges (both Rubik's
    builders), and under the face edits every x and y hinge, four z hinges
    and four drivers; the perpendicular cube's outer bound, which the
    Rubik's builders keep, is there, and so are the names the envs bind."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(tree["floor/basic_floor.xml"])))
    hand = t_xml.MjcfXML.parse(tree["robot/shadowhand/main.xml"])
    assert [e.tag for e in hand.find_named("hand_base")] == ["geom"]
    assert [e.tag for e in hand.find_named("annotation:outer_bound")] == ["site"]
    for f in ("rubik/rubik_locked.xml", "rubik/rubik_perpendicular.xml"):
        assert [e.tag for e in t_xml.MjcfXML.parse(tree[f]).find_named(
            "annotation:outer_bound")] == ["site"]
    perp = t_xml.MjcfXML.parse(tree["rubik/rubik_perpendicular.xml"])
    joints = [e.get("name") for e in perp.root_element.iter("joint")]
    springs = [j for j in joints if j.startswith("cubelet:spring:")]
    assert len(springs) == 20
    face_gone = springs + [j for j in joints if j.startswith(("cubelet:rotx:", "cubelet:roty:"))]
    face_gone += t_face._REMOVED_ROTZ + t_face._REMOVED_DRIVERS
    assert set(face_gone) <= set(joints) and len(face_gone) == 20 + 40 + 4 + 4
    assert os.path.isfile(os.path.join(root, "stls", "wrist.stl"))
    worlds = {w: t_worlds.compile_world(w, "cpu") for w in t_worlds.COMPOSED}
    for world, model in worlds.items():
        names = _names(model)
        for gone in ("robot0:hand_base", "robot0:annotation:outer_bound",
                     "target:annotation:outer_bound"):
            assert gone not in names, (world, gone)
        assert ("cube:annotation:outer_bound" in names) == world.startswith("rubik_"), world
        assert not any(":cubelet:spring:" in n for n in names), world
        assert "robot0:hand_mount" in names and "floor" in names
    face = _names(worlds["rubik_face_composed"])
    assert not any("cube:" + j in face for j in face_gone)
    assert all("cube:" + j in face for j in t_face.TOP_FACE_JOINTS + t_face.BOTTOM_FACE_JOINTS)
    full = _names(worlds["rubik_full_composed"])
    assert all("cube:" + j in full for j in joints if not j.startswith("cubelet:spring:"))
    locked = worlds["dactyl_locked_composed"]
    assert {"cube:cube_rot", "target:cube_rot", "cube:center", "cube:middle"} <= _names(locked)
    assert (locked.const.nq, locked.const.nv) == (38, 36)
    assert (worlds["rubik_face_composed"].const.nv, worlds["rubik_full_composed"].const.nv,
            worlds["dactyl_reach_composed"].const.nv) == (48, 96, 24)
    assert "target:S_fftip" in _names(worlds["dactyl_reach_composed"])


# ---------------------------------------------------------------------------
# the locked env on its composed world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def locked_port():
    return t_locked.make_env(device="cpu", seed=0,
                             model=t_worlds.compile_world("dactyl_locked_composed", "cpu"))


@pytest.fixture(scope="module")
def locked_jax():
    """The JAX LockedEnv as its constructor composes it from the tree."""
    with jax_boxbox_kernel():
        return j_locked.LockedEnv(j_locked.LockedEnvConstants(), dtype=jnp.float32)


@pytest.fixture(scope="module")
def locked_jax_reset(locked_jax):
    keys = jax.random.split(jax.random.PRNGKey(11), B)
    with jax_boxbox_kernel():
        state, obs = jax.jit(jax.vmap(locked_jax.reset))(keys)
    return keys, state, obs


def test_locked_env_on_the_composed_world(locked_port, locked_jax, locked_jax_reset):
    """The index tables bind alike; the construction's settle (the cube on
    the palm), `reset_physics` on the JAX keys' draws and two env steps
    from the JAX reset state, by tests/test_torch_env.py's checks. The
    target cube has no spring here (the builder parses one cube file
    twice): it falls freely in both packages."""
    tenv.test_hand_and_cube_index_bind(locked_port, locked_jax)
    tenv.test_settle_matches_jax(locked_port, locked_jax)
    tenv.test_reset_physics_matches_jax(locked_port, locked_jax, locked_jax_reset)
    step = jax.jit(jax.vmap(locked_jax.step))

    def jax_step(state, action):
        with jax_boxbox_kernel():
            return step(state, action)

    tenv.test_step_matches_jax(locked_port, locked_jax, locked_jax_reset, jax_step)
    z = locked_port._settled_data.qpos[0, locked_port.cube.target_pos_qpos[2]]
    assert float(z) < 0.0, "the target cube rests where it should fall"


# ---------------------------------------------------------------------------
# the reach env on its composed world
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reach_jax():
    return j_reach.ReachEnv(j_reach.ReachEnvConstants(), dtype=jnp.float32)


@pytest.fixture(scope="module")
def reach_port_built():
    return t_reach.make_env(device="cpu", seed=0,
                            model=t_worlds.compile_world("dactyl_reach_composed", "cpu"))


def test_reach_env_on_the_composed_world(reach_port_built, reach_jax):
    """The construction's settle, then, from the JAX env's settled start,
    the reset (the goal sims by the nudge rule) and three steps with both
    packages' nudged runs, by tests/test_torch_reach.py's checks."""
    treach.test_settle_matches_jax(reach_port_built, reach_jax)
    port = copy.copy(reach_port_built)
    port._initial_data = bridge.data_from_numpy(
        {k: v[None] for k, v in bridge.data_to_numpy(reach_jax._initial_data).items()}, "cpu")
    keys = jax.random.split(jax.random.PRNGKey(21), treach.B)
    reset = jax.jit(jax.vmap(reach_jax.reset))(keys)
    treach.test_reset_matches_jax(port, reach_jax, (keys,) + tuple(reset))
    treach.test_three_steps_match_jax(port, reach_jax, (keys,) + tuple(reset))


# ---------------------------------------------------------------------------
# the Rubik's envs, the port alone
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("world,module", [("rubik_face_composed", t_face),
                                          ("rubik_full_composed", t_full)])
def test_rubik_env_runs_on_the_composed_world(world, module):
    """Built on the composed world (its settle), reset and stepped at B=2:
    finite physics and observations, the cube on the palm after the reset,
    the face angles read from the world's drivers."""
    env = module.make_env(device="cpu", seed=0, model=t_worlds.compile_world(world, "cpu"))
    state, obs = env.reset(2)
    assert bool(t_cube.is_on_palm(env.cube, state.physics).all())
    action = torch.rand((2, env.action_size), generator=torch.Generator().manual_seed(0)) * 2 - 1
    state, obs, reward, done, info = env.step(state, action)
    for v in list(obs.values()) + [reward, state.physics.qpos, state.physics.qvel]:
        assert bool(torch.isfinite(v).all())
    assert tuple(obs["cube_face_angle"].shape) == (2, 2 if module is t_face else 6)
