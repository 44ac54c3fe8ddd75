"""The port's XML tools, worldgen parser, rearrange world composition, env
finder and compiled-world envs against the JAX package's.

`MjcfXML` composition, `scale_contact_budgets`, `build_settle_world_xml`
and the worldgen round trip give the JAX package's strings and values;
`blocks.compile_worlds` compiles the worlds the committed snapshots hold,
and the blocks env built on them runs as the env built on the snapshots,
bit for bit.
"""

import dataclasses
import json
import os
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogym_torch import bridge
from robogym_torch.envs.rearrange import blocks as t_blocks
from robogym_torch.envs.rearrange import dominos as t_dominos
from robogym_torch.envs.rearrange import holdout as t_holdout
from robogym_torch.envs.rearrange import simulation as t_sim
from robogym_torch.mjcf import compiler as t_compiler
from robogym_torch.mjcf import xml_tools as t_xml
from robogym_torch.utils import env_utils as t_env_utils
from robogym_torch.worldgen import parser as t_wg
from robogym_torch.worlds import holdout_ball_like, rearrange_blocks_like
from robogym_tpu.envs.rearrange import simulation as j_sim
from robogym_tpu.mjcf import compiler as j_compiler
from robogym_tpu.mjcf import xml_tools as j_xml
from robogym_tpu.worldgen import parser as j_wg

PART = """
<mujoco>
  <worldbody>
    <body name="arm" pos="0 0 0.5">
      <joint name="arm_j" type="hinge" axis="0 1 0"/>
      <geom name="arm_g" type="capsule" size="0.01 0.1" material="steel"/>
      <site name="arm_s" pos="0 0 0.1"/>
      <include file="hand.xml"/>
    </body>
  </worldbody>
  <asset><material name="steel" rgba="0.6 0.6 0.6 1"/></asset>
  <actuator><motor name="arm_m" joint="arm_j" gear="2"/></actuator>
  <tendon><fixed name="arm_t"><joint joint="arm_j" coef="1"/></fixed></tendon>
</mujoco>
"""

HAND = """
<mujocoinclude>
  <body name="hand" pos="0 0 0.2">
    <geom name="hand_g" type="box" size="0.02 0.02 0.02"/>
  </body>
</mujocoinclude>
"""

BASE = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody><geom name="floor" type="plane" size="1 1 0.1"/></worldbody>
  <default><geom rgba="1 1 1 1"/></default>
</mujoco>
"""


def _compose(lib, tmp):
    """A document composed through every `MjcfXML` edit, with `lib`'s
    package: (xml string, names found)."""
    base = lib.MjcfXML.from_string(BASE, base_dir=tmp)
    part = lib.MjcfXML.parse(os.path.join(tmp, "part.xml")).add_name_prefix("r0:")
    other = lib.MjcfXML.from_string(PART, base_dir=tmp).add_name_prefix(
        "r1:", exclude_attribs=["material"])
    xml = base.append(part).append(other).add_default_compiler_directive()
    xml.set_objects_attr(tag="option", timestep=0.001)
    xml.set_named_objects_attr("r0:arm_g", tag="geom", size=np.array([0.02, 0.2]))
    xml.set_prefixed_objects_attr("r1:", tag="geom", friction=[0.5, 0.01, 0.001])
    xml.replace_name("r0:hand", "r0:palm")
    xml.remove_objects_by_tag("tendon").remove_objects_by_name(["r1:arm_m"], tag="motor")
    xml.remove_objects_by_prefix("r1:hand")
    found = [el.tag for el in xml.find_named("r0:palm")]
    return xml.xml_string(), found


def test_mjcf_xml_composition_matches_the_jax_package(monkeypatch):
    with tempfile.TemporaryDirectory() as tmp:
        # one assets directory for both packages' compiler directive (the
        # JAX package fixes its directories when it is imported)
        monkeypatch.setattr(t_xml, "ASSETS_DIR", tmp)
        monkeypatch.setattr(j_xml.MjcfXML, "meshdir", os.path.join(tmp, "stls"))
        monkeypatch.setattr(j_xml.MjcfXML, "texturedir", os.path.join(tmp, "textures"))
        for name, text in (("part.xml", PART), ("hand.xml", HAND)):
            with open(os.path.join(tmp, name), "w") as f:
                f.write(text)
        got, want = _compose(t_xml, tmp), _compose(j_xml, tmp)
    assert got == want
    assert 'name="r0:palm"' in got[0] and "r1:hand" not in got[0] and got[1] == ["body"]
    assert t_xml._stringify(np.array([0.5, 1.0])) == j_xml._stringify(np.array([0.5, 1.0]))


def test_assets_dir_follows_the_jax_packages_variable(tmp_path):
    """Both packages read their assets directory from ROBOGYM_TPU_ASSETS."""
    code = ("from robogym_torch.mjcf import xml_tools as t; from robogym_tpu.mjcf import "
            "xml_tools as j; print(t.ASSETS_DIR == j.ASSETS_DIR == %r, t.XML_DIR == j.XML_DIR)"
            % str(tmp_path))
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, ROBOGYM_TPU_ASSETS=str(tmp_path), PYTHONPATH=repo)
    out = subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120).stdout
    assert out.split() == ["True", "True"]


def test_assets_dir_unset_names_its_variable():
    """Without ROBOGYM_TPU_ASSETS the port has no assets directory, and
    parsing one of robogym's asset XMLs raises FileNotFoundError naming the
    file and the variable."""
    code = ("from robogym_torch.mjcf import xml_tools as t\n"
            "assert t.ASSETS_DIR is None and t.XML_DIR is None\n"
            "try:\n    t.MjcfXML.parse('robot/ur16e/base.xml')\n"
            "except FileNotFoundError as e:\n    print(e)\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "ROBOGYM_TPU_ASSETS"}
    env["PYTHONPATH"] = repo
    out = subprocess.run([sys.executable, "-c", code], check=True, cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120).stdout
    assert "robot/ur16e/base.xml" in out and "ROBOGYM_TPU_ASSETS" in out


def test_worldgen_round_trip_matches_the_jax_package():
    """tests/test_tooling.py's round trip: the same normalized values and
    the same strings back."""
    src = """
    <mujoco>
      <option timestep="0.002" gravity="0 0 -9.81"/>
      <worldbody>
        <body name="b" pos="0.1 0.2 0.3">
          <geom name="g" type="box" size="0.01 0.02 0.03" rgba="1 0 0 1" mass="2"/>
          <joint name="j" type="hinge" damping="0.5" limited="true"/>
        </body>
      </worldbody>
    </mujoco>
    """
    got, want = t_wg.parse_string(src), j_wg.parse_string(src)
    body = got["mujoco"]["worldbody"]["body"][0]
    np.testing.assert_array_equal(body["@pos"], want["mujoco"]["worldbody"]["body"][0]["@pos"])
    assert body["joint"][0]["@limited"] is True and isinstance(body["geom"][0]["@mass"], float)
    assert got["mujoco"]["option"]["@timestep"] == want["mujoco"]["option"]["@timestep"]
    t_wg.stringify(got)
    j_wg.stringify(want)
    assert got == want
    assert t_wg.unparse_dict(got) == j_wg.unparse_dict(want)
    with tempfile.NamedTemporaryFile("w", suffix=".xml", delete=False) as f:
        f.write(src)
    try:
        a, b = t_wg.parse_file(f.name), j_wg.parse_file(f.name)
    finally:
        os.unlink(f.name)
    t_wg.stringify(a)
    j_wg.stringify(b)
    assert a == b


def _main_worlds(tmp):
    """(JAX model, port model) of the stand-in's 8-block main world."""
    build = rearrange_blocks_like.world_xml_builder(tmp)
    jm = j_compiler.compile_xml(rearrange_blocks_like.write(tmp), dtype=jnp.float32)
    tm, idx = t_sim.compile_blocks_world(8, device="cpu", build_world_xml=build)
    return jm, tm, idx


def test_world_composition_matches_the_jax_package():
    """`make_block_xml`, `scale_contact_budgets` and
    `build_settle_world_xml` give the JAX package's strings and values; the
    port's blocks world of the stand-in's builder is the JAX compile of the
    stand-in."""
    assert t_sim.make_block_xml("object3", [0.01, 0.02, 0.03]).xml_string() == \
        j_sim.make_block_xml("object3", [0.01, 0.02, 0.03]).xml_string()
    with tempfile.TemporaryDirectory() as tmp:
        jm, tm, idx = _main_worlds(tmp)
        assert idx.max_num_objects == 8 and len(idx.object_geom_ids) == 8
        ja, ta = bridge.model_to_numpy(jm), bridge.model_to_numpy(tm)
        assert sorted(ja) == sorted(ta) and all(np.array_equal(ja[k], ta[k]) for k in ja)
        for n, extra in ((0, 0), (2, 1), (8, 0), (8, 16), (40, 3)):
            a, b = t_sim.scale_contact_budgets(tm, n, extra), j_sim.scale_contact_budgets(jm, n,
                                                                                            extra)
            assert (a.opt.ncon_active, a.opt.group_cap) == (b.opt.ncon_active, b.opt.group_cap)
            assert (a is tm) == (b is jm)
        got = t_sim.build_settle_world_xml(tm.const._source_xml)
        want = j_sim.build_settle_world_xml(jm.const._source_xml)
        assert got.xml_string() == want.xml_string()
        settle = t_compiler.compile_xml(got, device="cpu")
    with np.load(rearrange_blocks_like.SETTLE_SNAPSHOT) as z:
        snap = {k: z[k] for k in z.files}
    ts = bridge.model_to_numpy(settle)
    assert sorted(ts) == sorted(snap) and all(np.array_equal(ts[k], snap[k]) for k in ts)


def test_blocks_world_xml_reads_the_reference_assets(tmp_path, monkeypatch):
    """With an assets directory that lacks robogym's assets, both packages'
    `build_blocks_world_xml` fail alike on the UR16e's base XML."""
    for lib in (t_xml, j_xml):
        monkeypatch.setattr(lib, "ASSETS_DIR", str(tmp_path))
        monkeypatch.setattr(lib, "XML_DIR", str(tmp_path / "xmls"))
    for lib in (t_sim, j_sim):
        with pytest.raises(FileNotFoundError, match="ur16e"):
            lib.build_blocks_world_xml(2)


@pytest.mark.parametrize("env", ["blocks", "dominos"])
def test_compile_worlds_gives_the_snapshots(env):
    """`compile_worlds` with the stand-in's builder compiles the main world
    (the env class's `_compile_world`), the solver world and, under
    `stabilize_goal` (the blocks env here), the settle world that the
    committed snapshots hold."""
    cst, par = t_blocks.configs({"goal_args": {"stabilize_goal": env == "blocks"}}, {})
    snaps = dict(model=rearrange_blocks_like.SNAPSHOT if env == "blocks"
                 else rearrange_blocks_like.DOMINOS_SNAPSHOT,
                 solver_model=rearrange_blocks_like.SOLVER_SNAPSHOT)
    if env == "blocks":
        snaps["settle_model"] = rearrange_blocks_like.SETTLE_SNAPSHOT
    env_class = t_blocks.BlocksRearrangeEnv if env == "blocks" else t_dominos.DominosRearrangeEnv
    with tempfile.TemporaryDirectory() as tmp:
        worlds = t_blocks.compile_worlds(cst, par, "cpu",
                                         rearrange_blocks_like.world_xml_builder(tmp), env_class)
    assert sorted(worlds) == sorted(snaps)
    for key, path in snaps.items():
        got = bridge.model_to_numpy(worlds[key])
        with np.load(path) as z:
            assert sorted(got) == sorted(z.files)
            for k in z.files:
                assert got[k].dtype == z[k].dtype and np.array_equal(got[k], z[k]), (key, k)


def test_compile_worlds_of_mesh_and_holdout_objects_has_no_settle_world():
    """Mesh objects settle in the full model, so no settle world for them;
    the holdout's world is its config's objects, as the JAX env compiles
    it (the stand-in's cylinder pair needs the ascending pair table, which
    `worlds/compile.py` applies; here it is left out, as the JAX env
    compiles it)."""
    from robogym_torch.utils import jsonnet

    sim = jsonnet.evaluate_file(holdout_ball_like.CONFIG)["make_env"]["args"]["parameters"][
        "simulation_params"]
    cst, par = t_blocks.configs({"goal_args": {"stabilize_goal": True}}, {})
    with tempfile.TemporaryDirectory() as tmp:
        import shutil

        shutil.copy(holdout_ball_like.PLATFORM_STL, tmp)
        worlds = t_blocks.compile_worlds(
            cst, par, "cpu", rearrange_blocks_like.world_xml_builder(tmp),
            t_holdout.HoldoutRearrangeEnv, task_object_configs=sim["task_object_configs"],
            scene_object_configs=sim["scene_object_configs"])
    names = worlds["model"].const.names
    assert {"object0", "object1", "scene0_0"} <= set(names["body"])
    assert sorted(worlds) == ["model", "settle_model", "solver_model"]  # a sphere and a cylinder
    from robogym_torch.envs.rearrange import mesh as t_mesh
    from robogym_torch.worlds.compile import _stand_in

    with tempfile.TemporaryDirectory() as tmp, _stand_in(tmp) as build:
        files = t_mesh.find_meshes_by_dirname(os.path.join(tmp, "stls", "ycb"))
        worlds = t_blocks.compile_worlds(cst, par, "cpu", build, t_mesh.MeshRearrangeEnv,
                                         mesh_files=files)
    assert sorted(worlds) == ["model", "solver_model"]


def test_make_env_finder_finds_the_ports_envs():
    """By a `.py` path, a `.json` config, the holdout stand-in's `.jsonnet`
    and a name fragment, each the port's factory."""
    from robogym_torch.envs.rearrange import dominos

    find = t_env_utils.MakeEnvFinder.find
    assert find(t_blocks.__file__) is t_blocks.make_env
    assert find("rearrange/dominos") is dominos.make_env
    assert find("no_such_env_anywhere") is None
    fn = find(holdout_ball_like.CONFIG)
    assert fn.func is t_holdout.make_env and "parameters" in fn.keywords
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dominos.json")
        with open(path, "w") as f:
            json.dump({"make_env": {"function": "robogym.envs.rearrange.dominos:make_env",
                                    "args": {"constants": {"is_holdout": True}}}}, f)
        fn = find(path)
    assert fn.func is dominos.make_env and fn.keywords == {"constants": {"is_holdout": True}}
    assert t_env_utils.gym_space_from_arrays({"a": torch.zeros(2, 3), "b": {"c": np.ones(4)}}) \
        == {"a": (2, 3), "b": {"c": (4,)}}
    with pytest.raises(ValueError, match="no env found"):
        t_env_utils.load_env("no_such_env_anywhere")


FAST = {"mujoco_substeps": 2, "stabilize_steps": 1, "goal_args": {"stabilize_goal": True}}


def _run(env, batch=2, steps=2):
    state, obs = env.reset(batch)
    out = [(state, obs)]
    gen = torch.Generator().manual_seed(0)
    for _ in range(steps):
        action = torch.rand((batch, env.action_size), generator=gen) * 2 - 1
        state, obs, reward, done, _ = env.step(state, action)
        out.append((state, obs, reward, done))
    return out


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (tuple, list)):
        return [v for item in x for v in _leaves(item)]
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x) for v in _leaves(getattr(x, f.name))]
    return []


def test_blocks_env_on_compiled_worlds_equals_the_snapshot_env():
    """The blocks env (TCP control through its solver sim, under
    `stabilize_goal`) built on `compile_worlds` with the stand-in's builder
    resets and takes two steps exactly as the env built on `load_worlds`."""
    cst, par = t_blocks.configs(FAST, {})
    with tempfile.TemporaryDirectory() as tmp:
        compiled = t_blocks.compile_worlds(cst, par, "cpu",
                                           rearrange_blocks_like.world_xml_builder(tmp))
    assert sorted(compiled) == ["model", "settle_model", "solver_model"]
    got = _run(t_blocks.make_env(FAST, {}, device="cpu", worlds=compiled))
    want = _run(t_blocks.make_env(FAST, {}, device="cpu"))
    for g, w in zip(got, want):
        gl, wl = _leaves(g), _leaves(w)
        assert len(gl) == len(wl) > 0
        for a, b in zip(gl, wl):
            assert torch.equal(a, b)
