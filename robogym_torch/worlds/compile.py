"""Compile the stand-in worlds with the port's own compiler.

`compile_world(world, device)` builds each of the 25 worlds whose
snapshots ship in this directory (`WORLDS`), step by step as
`tools/build_locked_like_snapshot.py` builds them with the JAX package's
compiler, but with this package's modules only: the worlds' writers, the
rearrange composition (`envs/rearrange/simulation.py`), the envs'
`_compile_world` counterparts and `mjcf/compiler.compile_xml`. Its result
equals the committed snapshot field by field (`tests/test_torch_compiler.py`;
on the card, `chip_smoke.py`'s `[compile]` phase).

The mesh envs' stand-ins are composed as the JAX tool composes them: the
candidate STLs copied under a temporary assets directory's `stls`, which
`xml_tools.ASSETS_DIR` names while the world compiles (`_stand_in`), and
the world's base XML from `rearrange_blocks_like.world_xml_builder` of that
`stls`. The holdout stand-in is compiled with the pair table keyed in
ascending type order (`sorted_pair_table`). The four composed dactyl
worlds (`COMPOSED`) are built by the envs' own builders from the stand-in
asset tree of `dactyl_assets_like.write_assets`, written into a temporary
directory that `xml_tools.ASSETS_DIR` names while the world compiles
(`assets_tree`).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile

import torch

from robogym_torch.mjcf import compiler, xml_tools
from robogym_torch.mjcf.model import Model

WORLDS = ("locked_like", "locked_like_hand", "blocks_settle_like", "table_setting_like",
          "dactyl_locked_like", "rearrange_blocks_like", "rearrange_solver_like",
          "rearrange_settle_like", "rearrange_dominos_like", "rearrange_wordblocks_like",
          "rubik_face_like", "rubik_full_like", "dactyl_reach_like", "rearrange_ycb_like",
          "holdout_ball_like", "rearrange_table_setting_like", "rearrange_chessboard_like",
          "rearrange_mixture_like", "rearrange_composer_like", "dactyl_vision_like",
          "rearrange_vision_like", "dactyl_locked_composed", "rubik_face_composed",
          "rubik_full_composed", "dactyl_reach_composed")
# the composed dactyl worlds: the env module whose `compile_world` builds each
COMPOSED = {"dactyl_locked_composed": "cube_env", "rubik_face_composed": "face_perpendicular",
            "rubik_full_composed": "full_perpendicular", "dactyl_reach_composed": "reach"}
MESH_FAMILY = {"rearrange_table_setting_like": "table_setting",
               "rearrange_chessboard_like": "chessboard", "rearrange_mixture_like": "mixture",
               "rearrange_composer_like": "composer"}


@contextlib.contextmanager
def sorted_pair_table():
    """Inside, the compiler finds every pair type of its table. It looks a
    pair up by its two geom types in ascending order but keys four of its
    entries the other way round (box-cylinder, box-ellipsoid,
    mesh-cylinder, mesh-ellipsoid), so it drops those pairs, as the JAX
    compiler does. The stand-in holdout's cylinder stands on the table, so
    its world is compiled with the keys in ascending order."""
    orig = compiler._PAIR_NCON
    compiler._PAIR_NCON = {(min(a, b), max(a, b)): n for (a, b), n in orig.items()}
    try:
        yield
    finally:
        compiler._PAIR_NCON = orig


@contextlib.contextmanager
def assets_tree():
    """Inside, `xml_tools.ASSETS_DIR` (and `XML_DIR`) name a temporary
    directory holding the stand-in asset tree (`dactyl_assets_like`).
    Yields the directory."""
    from robogym_torch.worlds import dactyl_assets_like

    orig = xml_tools.ASSETS_DIR, xml_tools.XML_DIR
    with tempfile.TemporaryDirectory() as tmp:
        dactyl_assets_like.write_assets(tmp)
        xml_tools.ASSETS_DIR, xml_tools.XML_DIR = tmp, os.path.join(tmp, "xmls")
        try:
            yield tmp
        finally:
            xml_tools.ASSETS_DIR, xml_tools.XML_DIR = orig


def _composed_world(world: str, device) -> Model:
    """A composed dactyl world: its env module's `compile_world` on the
    stand-in asset tree (the locked env's default constants: no vision
    cameras)."""
    import importlib

    module = importlib.import_module("robogym_torch.envs.dactyl." + COMPOSED[world])
    with assets_tree():
        if world == "dactyl_locked_composed":
            from robogym_torch.envs.dactyl.locked import LockedEnvConstants

            return module.compile_world(LockedEnvConstants(), device)
        return module.compile_world(None, device)


@contextlib.contextmanager
def _stand_in(root: str, ycb_dir: str = None, extra_xml: str = None):
    """Inside, `xml_tools.ASSETS_DIR` is `root`, whose `stls` holds copies of
    the YCB stand-ins (`ycb`; the table setting's tableware where `ycb_dir`
    names it), the chess pieces (`chess`) and the shapes (`geom`). Yields
    the base world's builder: the stand-in arm and table, writing into
    `root/stls`, and the YCB stand-in's table-top plane (and `extra_xml`,
    where given)."""
    from robogym_torch.mjcf.xml_tools import MjcfXML
    from robogym_torch.worlds import (rearrange_blocks_like, rearrange_mesh_family_like,
                                      rearrange_ycb_like)

    stls = os.path.join(root, "stls")
    shutil.copytree(ycb_dir or rearrange_ycb_like.MESH_DIR, os.path.join(stls, "ycb"))
    for name in ("chess", "geom"):
        shutil.copytree(os.path.join(rearrange_mesh_family_like.MESH_ROOT, name),
                        os.path.join(stls, name))
    base = rearrange_blocks_like.world_xml_builder(stls)

    def build(max_num_objects, block_size=rearrange_blocks_like.BLOCK_HALF,
              robot_control_params=None, mujoco_timestep=0.001):
        xml = base(max_num_objects, block_size, robot_control_params, mujoco_timestep).append(
            MjcfXML.from_string(rearrange_ycb_like.table_top_xml()))
        return xml.append(MjcfXML.from_string(extra_xml)) if extra_xml else xml

    orig = xml_tools.ASSETS_DIR
    xml_tools.ASSETS_DIR = root
    try:
        yield build
    finally:
        xml_tools.ASSETS_DIR = orig


def _family_files(env: str, root: str):
    """The candidates of `env`'s bank under `root/stls`, as the JAX env
    gathers them: the mixture's merged under "<dirname>/<name>", the table
    setting's kept to its mesh names."""
    from robogym_torch.envs.rearrange.mesh import find_meshes_by_dirname

    def under(d):
        return find_meshes_by_dirname(os.path.join(root, "stls", d))

    if env == "mixture":
        return {f"{d}/{k}": v for d in ("ycb", "geom") for k, v in under(d).items()}
    if env == "table_setting":
        from robogym_torch.envs.rearrange.table_setting import MESH_NAMES

        return {k: v for k, v in under("ycb").items() if k in MESH_NAMES}
    return under("chess" if env == "chessboard" else "ycb")


def _family_world(env: str, device) -> Model:
    """`env`'s world ("table_setting", "chessboard", "mixture" or
    "composer"), compiled by its env class's `_compile_world` at the
    stand-in's slot count."""
    from robogym_torch.envs.rearrange import blocks, composer, mesh
    from robogym_torch.robot.composite import RobotControlParameters
    from robogym_torch.worlds import rearrange_mesh_family_like as family

    O = family.SLOTS[env]
    par = blocks.RearrangeEnvParameters(
        simulation_params=blocks.RearrangeSimParameters(num_objects=min(O, 5), max_num_objects=O),
        robot_control_params=RobotControlParameters())
    env_class, cst = mesh.MeshRearrangeEnv, mesh.MeshRearrangeEnvConstants()
    if env == "composer":
        env_class, cst = composer.ComposerRearrangeEnv, composer.ComposerEnvConstants()
    ycb_dir, extra = (family.TABLEWARE_DIR, family.table_setting_contact_xml()) \
        if env == "table_setting" else (None, None)
    with tempfile.TemporaryDirectory() as tmp, _stand_in(tmp, ycb_dir, extra) as build:
        return env_class._compile_world(cst, par, device, build,
                                        mesh_files=_family_files(env, tmp))


def _holdout_world(device) -> Model:
    from robogym_torch.envs.rearrange import blocks, holdout
    from robogym_torch.robot.composite import RobotControlParameters
    from robogym_torch.utils import jsonnet
    from robogym_torch.worlds import holdout_ball_like, rearrange_blocks_like

    sim = jsonnet.evaluate_file(holdout_ball_like.CONFIG)["make_env"]["args"]["parameters"][
        "simulation_params"]
    par = blocks.RearrangeEnvParameters(robot_control_params=RobotControlParameters())
    with tempfile.TemporaryDirectory() as tmp, sorted_pair_table():
        shutil.copy(holdout_ball_like.PLATFORM_STL, tmp)
        return holdout.HoldoutRearrangeEnv._compile_world(
            blocks.RearrangeEnvConstants(), par, device,
            rearrange_blocks_like.world_xml_builder(tmp),
            task_object_configs=sim["task_object_configs"],
            scene_object_configs=sim["scene_object_configs"])


def compile_world(world: str, device="cuda", dtype=torch.float32) -> Model:
    """The port's compile of `world` (one of `WORLDS`) on `device`, as
    `tools/build_locked_like_snapshot.compile_snapshot` compiles it with the
    JAX package."""
    from robogym_torch.envs.rearrange import blocks, mesh
    from robogym_torch.envs.rearrange import simulation as sim_lib
    from robogym_torch.mjcf.xml_tools import MjcfXML
    from robogym_torch.robot.composite import RobotControlParameters
    from robogym_torch.worlds import (blocks_settle_like, dactyl_locked_like, dactyl_reach_like,
                                      locked_like, rearrange_blocks_like, rearrange_ycb_like,
                                      rubik_face_like, rubik_full_like, table_setting_like,
                                      vision_like)

    def compile_xml(xml):
        return compiler.compile_xml(xml, dtype=dtype, device=device)

    scale = sim_lib.scale_contact_budgets
    if world not in WORLDS:
        raise ValueError(f"unknown world {world!r}; want one of {WORLDS}")
    if world in MESH_FAMILY:
        return _family_world(MESH_FAMILY[world], device)
    if world in COMPOSED:
        return _composed_world(world, device)
    if world == "holdout_ball_like":
        return _holdout_world(device)
    if world == "rearrange_ycb_like":
        n = rearrange_ycb_like.MAX_NUM_OBJECTS
        with tempfile.TemporaryDirectory() as tmp, _stand_in(tmp) as build:
            files = mesh.find_meshes_by_dirname(os.path.join(tmp, "stls", "ycb"))
            first = sorted(files)[0]
            xml = build(0)
            for i in range(n):
                xml.append(mesh.make_mesh_object_xml(f"object{i}", files[first][0], 1.0))
            return scale(compile_xml(xml), n)
    with tempfile.TemporaryDirectory() as tmp:
        if world == "dactyl_vision_like":
            return compile_xml(vision_like.write_dactyl(tmp))
        if world == "rearrange_vision_like":
            return scale(compile_xml(vision_like.write_rearrange(tmp)),
                         rearrange_blocks_like.MAX_NUM_OBJECTS)
        if world == "blocks_settle_like":
            return scale(compile_xml(blocks_settle_like.write()), blocks_settle_like.N_BLOCKS)
        if world == "table_setting_like":
            return scale(compile_xml(table_setting_like.write(tmp)), table_setting_like.N_OBJECTS)
        if world in ("dactyl_locked_like", "rubik_face_like", "rubik_full_like",
                     "dactyl_reach_like"):
            module = {"dactyl_locked_like": dactyl_locked_like,
                      "rubik_face_like": rubik_face_like, "rubik_full_like": rubik_full_like,
                      "dactyl_reach_like": dactyl_reach_like}[world]
            return compile_xml(module.write(tmp))
        if world == "rearrange_settle_like":
            main = compile_xml(rearrange_blocks_like.write(tmp))
            return compile_xml(sim_lib.build_settle_world_xml(main.const._source_xml))
        build = rearrange_blocks_like.world_xml_builder(tmp)
        if world == "rearrange_dominos_like":
            n = rearrange_blocks_like.MAX_NUM_OBJECTS
            xml = build(0)
            for i in range(n):
                xml.append(sim_lib.make_block_xml(
                    f"object{i}",
                    rearrange_blocks_like.BLOCK_HALF * rearrange_blocks_like.DOMINO_PROPORTIONS))
            return scale(compile_xml(xml), n)
        if world == "rearrange_solver_like":
            return sim_lib.compile_solver_world(RobotControlParameters(), dtype=dtype,
                                                device=device, build_world_xml=build)
        if world in ("rearrange_blocks_like", "rearrange_wordblocks_like"):
            n = {"rearrange_blocks_like": rearrange_blocks_like.MAX_NUM_OBJECTS,
                 "rearrange_wordblocks_like": rearrange_blocks_like.WORDBLOCKS_OBJECTS}[world]
            par = blocks.RearrangeEnvParameters(
                simulation_params=blocks.RearrangeSimParameters(max_num_objects=n),
                robot_control_params=RobotControlParameters())
            return blocks.BlocksRearrangeEnv._compile_world(blocks.RearrangeEnvConstants(), par,
                                                            device, build)
        return compile_xml(locked_like.write(tmp, hand_only=world == "locked_like_hand"))


def snapshot_path(world: str) -> str:
    """The committed snapshot of `world`."""
    from robogym_torch.worlds import (blocks_settle_like, dactyl_locked_like, dactyl_reach_like,
                                      holdout_ball_like, locked_like, rearrange_blocks_like,
                                      rearrange_mesh_family_like, rearrange_ycb_like,
                                      rubik_face_like, rubik_full_like, table_setting_like,
                                      vision_like)

    if world in MESH_FAMILY:
        return rearrange_mesh_family_like.SNAPSHOTS[MESH_FAMILY[world]]
    if world in COMPOSED:
        return os.path.join(os.path.dirname(os.path.abspath(__file__)), world + ".npz")
    return {"locked_like": locked_like.SNAPSHOT, "locked_like_hand": locked_like.HAND_SNAPSHOT,
            "blocks_settle_like": blocks_settle_like.SNAPSHOT,
            "table_setting_like": table_setting_like.SNAPSHOT,
            "dactyl_locked_like": dactyl_locked_like.SNAPSHOT,
            "rearrange_blocks_like": rearrange_blocks_like.SNAPSHOT,
            "rearrange_solver_like": rearrange_blocks_like.SOLVER_SNAPSHOT,
            "rearrange_settle_like": rearrange_blocks_like.SETTLE_SNAPSHOT,
            "rearrange_dominos_like": rearrange_blocks_like.DOMINOS_SNAPSHOT,
            "rearrange_wordblocks_like": rearrange_blocks_like.WORDBLOCKS_SNAPSHOT,
            "rubik_face_like": rubik_face_like.SNAPSHOT,
            "rubik_full_like": rubik_full_like.SNAPSHOT,
            "dactyl_reach_like": dactyl_reach_like.SNAPSHOT,
            "rearrange_ycb_like": rearrange_ycb_like.SNAPSHOT,
            "holdout_ball_like": holdout_ball_like.SNAPSHOT,
            "dactyl_vision_like": vision_like.DACTYL_SNAPSHOT,
            "rearrange_vision_like": vision_like.REARRANGE_SNAPSHOT}[world]
