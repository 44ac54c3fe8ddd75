"""Compile the port's worlds with the JAX package's compiler and write their
snapshots next to their modules in `robogym_torch/worlds/`:

  * `locked_like.npz`, the hand-and-cube world;
  * `locked_like_hand.npz`, its hand-only variant (no cube, no collision);
  * `blocks_settle_like.npz`, the rearrange goal-settle world, and
    `table_setting_like.npz`, the table-setting goal-settle world of five
    free meshes, each with the contact budgets `scale_contact_budgets(model,
    5)` gives it;
  * `dactyl_locked_like.npz`, the hand-and-cube world with dactyl/locked's
    names and joints (nv = 36), which the env code binds to;
  * `rearrange_blocks_like.npz`, the UR16e-shaped rearrange world with 8
    blocks, joint-actuated (the main sim of the mocap_ik dual sim), with the
    contact budgets `scale_contact_budgets(model, 8)` gives it, as
    `envs/rearrange/blocks.py` compiles it; and `rearrange_solver_like.npz`,
    the same arm in mocap mode with no blocks (the solver sim,
    `compile_solver_world`);
  * `rearrange_settle_like.npz`, the objects-only goal-settle world that
    the blocks env compiles under `stabilize_goal`:
    `build_settle_world_xml` of the 8-block main world's source, compiled
    with the default contact budgets, as `envs/rearrange/blocks.py:216-233`
    compiles it;
  * `rearrange_dominos_like.npz`, the dominos world: the main world with no
    blocks plus 8 blocks of half-size `BLOCK_HALF * DOMINO_PROPORTIONS`, with
    the budgets of `scale_contact_budgets(model, 8)`, as
    `envs/rearrange/dominos.py` compiles it; and
    `rearrange_wordblocks_like.npz`, the main world at wordblocks' 6 blocks
    with the budgets of `scale_contact_budgets(model, 6)`;
  * `rubik_face_like.npz`, the hand and a cube of 26 box cubelets with the
    face-perpendicular env's names and joints (nv = 48), compiled as
    `envs/dactyl/face_perpendicular.py` compiles its world: plain
    `compile_xml`, the default contact budgets;
  * `rubik_full_like.npz`, the hand and a cube of 6 face centres and 20
    cubelets, each on its own hinges (nv = 96), with the full-perpendicular
    env's names and joints, compiled as `envs/dactyl/full_perpendicular.py`
    compiles its world: plain `compile_xml`, the default contact budgets;
  * `dactyl_reach_like.npz`, the hand alone at dactyl/reach's mount pose
    over a floor, force-limited, with five target sites (nv = 24),
    compiled as `envs/dactyl/reach.py` compiles its world: plain
    `compile_xml`, the default contact budgets;
  * `rearrange_ycb_like.npz`, the YCB env's world: the main world with no
    blocks and a plane on the table's top, plus 8 mesh slots of the first stand-in candidate
    (`rearrange_ycb_like.MESH_DIR`), with the budgets of
    `scale_contact_budgets(model, 8)`, as `envs/rearrange/mesh.py:211-227`
    compiles it (`ycb_stand_in`);
  * `holdout_ball_like.npz`, the stand-in holdout's world: the main world
    with no blocks plus the config's task and scene objects, with the
    budgets of `scale_contact_budgets(model, 2, 1)`, as
    `envs/rearrange/holdout.py:150-179` compiles it (`holdout_stand_in`);
  * `rearrange_table_setting_like.npz`, `rearrange_chessboard_like.npz`,
    `rearrange_mixture_like.npz` and `rearrange_composer_like.npz`, the
    worlds of the table setting, chessboard, mixture and composer envs on
    the stand-ins of `rearrange_mesh_family_like`, each compiled by the
    JAX env's own `_compile_world` (`mesh_family_world`);
  * `dactyl_vision_like.npz` and `rearrange_vision_like.npz`, the
    dactyl-shaped and the UR16e-shaped blocks worlds with vision cameras
    and a light (`vision_like`), compiled as their camera-less twins are;
  * `dactyl_locked_composed.npz`, `rubik_face_composed.npz`,
    `rubik_full_composed.npz` and `dactyl_reach_composed.npz`, the worlds
    the JAX dactyl envs compose themselves (`cube_env.build_cube_world_xml`
    of `rubik/rubik_locked.xml`, `face_perpendicular.build_face_world_xml`,
    `full_perpendicular.build_full_world_xml`, `reach.build_reach_xml`),
    compiled by the JAX compiler in float32 as their constructors compile
    them, from the stand-in asset tree that
    `robogym_torch/worlds/dactyl_assets_like.write_assets` writes into a
    temporary directory, to which the JAX `xml_tools` module's directories
    are pointed while the world composes (`jax_assets_tree`).

    JAX_PLATFORMS=cpu python tools/build_locked_like_snapshot.py [WORLD ...]

The port loads a snapshot with `robogym_torch.bridge.model_from_numpy`; a
test rebuilds each and checks that it matches the committed file field by
field.
"""

import contextlib
import os
import shutil
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORLDS = ("locked_like", "locked_like_hand", "blocks_settle_like", "table_setting_like",
          "dactyl_locked_like", "rearrange_blocks_like", "rearrange_solver_like",
          "rearrange_settle_like", "rearrange_dominos_like", "rearrange_wordblocks_like",
          "rubik_face_like", "rubik_full_like", "dactyl_reach_like", "rearrange_ycb_like",
          "holdout_ball_like", "rearrange_table_setting_like", "rearrange_chessboard_like",
          "rearrange_mixture_like", "rearrange_composer_like", "dactyl_vision_like",
          "rearrange_vision_like", "dactyl_locked_composed", "rubik_face_composed",
          "rubik_full_composed", "dactyl_reach_composed")
COMPOSED = ("dactyl_locked_composed", "rubik_face_composed", "rubik_full_composed",
            "dactyl_reach_composed")
MESH_FAMILY = {"rearrange_table_setting_like": "table_setting",
               "rearrange_chessboard_like": "chessboard", "rearrange_mixture_like": "mixture",
               "rearrange_composer_like": "composer"}


@contextlib.contextmanager
def jax_assets_tree():
    """Inside, the JAX package's `xml_tools` reads robogym's assets from a
    temporary directory holding the stand-in asset tree
    (`dactyl_assets_like.write_assets`): its `ASSETS_DIR` and `XML_DIR`,
    and `MjcfXML.meshdir` and `texturedir`, which it fixes when it is
    imported. Yields the directory."""
    from robogym_torch.worlds import dactyl_assets_like
    from robogym_tpu.mjcf import xml_tools

    cls = xml_tools.MjcfXML
    orig = xml_tools.ASSETS_DIR, xml_tools.XML_DIR, cls.meshdir, cls.texturedir
    with tempfile.TemporaryDirectory() as tmp:
        dactyl_assets_like.write_assets(tmp)
        xml_tools.ASSETS_DIR, xml_tools.XML_DIR = tmp, os.path.join(tmp, "xmls")
        cls.meshdir, cls.texturedir = os.path.join(tmp, "stls"), os.path.join(tmp, "textures")
        try:
            yield tmp
        finally:
            xml_tools.ASSETS_DIR, xml_tools.XML_DIR, cls.meshdir, cls.texturedir = orig


def composed_xml(world: str):
    """The JAX builder's document of a composed dactyl world (inside
    `jax_assets_tree`)."""
    from robogym_tpu.envs.dactyl import cube_env, face_perpendicular, full_perpendicular, reach

    return {"dactyl_locked_composed": lambda: cube_env.build_cube_world_xml(
                cube_env.CubeEnvBase.CUBE_XML),
            "rubik_face_composed": face_perpendicular.build_face_world_xml,
            "rubik_full_composed": full_perpendicular.build_full_world_xml,
            "dactyl_reach_composed": reach.build_reach_xml}[world]()


@contextlib.contextmanager
def ycb_stand_in(root: str, ycb_dir: str = None, extra_xml: str = None):
    """Inside, the JAX mesh envs compose their worlds from the stand-in's
    writer (and `extra_xml`, where given) and find their candidates,
    copies of the committed stand-in STLs, under `root/stls`: `ycb` (by
    default the YCB stand-ins of `rearrange_ycb_like.MESH_DIR`; the table
    setting's tableware where `ycb_dir` names it), `chess` and `geom`. The
    mesh env's and the composer's asset directory (`mesh.ASSETS_DIR`,
    `xml_tools.ASSETS_DIR`) is `root`. Yields the `ycb` candidates, {name:
    [STL path]}."""
    from robogym_torch.worlds import (rearrange_blocks_like, rearrange_mesh_family_like,
                                      rearrange_ycb_like)
    from robogym_tpu.envs.rearrange import mesh as j_mesh
    from robogym_tpu.envs.rearrange import simulation as j_sim
    from robogym_tpu.mjcf import xml_tools
    from robogym_tpu.mjcf.xml_tools import MjcfXML
    from robogym_tpu.robot import composite as j_comp

    stls = os.path.join(root, "stls")
    shutil.copytree(ycb_dir or rearrange_ycb_like.MESH_DIR, os.path.join(stls, "ycb"))
    for name in ("chess", "geom"):
        shutil.copytree(os.path.join(rearrange_mesh_family_like.MESH_ROOT, name),
                        os.path.join(stls, name))

    def write(max_num_objects, block_size=0.0254, robot_control_params=None,
              mujoco_timestep=0.001):
        rcp = robot_control_params or j_comp.RobotControlParameters()
        xml = MjcfXML.from_string(rearrange_blocks_like.write(
            stls, max_num_objects, block_size, rcp.is_joint_actuated(), mujoco_timestep)).append(
                MjcfXML.from_string(rearrange_ycb_like.table_top_xml()))
        return xml.append(MjcfXML.from_string(extra_xml)) if extra_xml else xml

    orig = j_sim.build_blocks_world_xml, j_mesh.ASSETS_DIR, xml_tools.ASSETS_DIR
    j_sim.build_blocks_world_xml, j_mesh.ASSETS_DIR, xml_tools.ASSETS_DIR = write, root, root
    try:
        yield j_mesh.find_meshes_by_dirname("ycb")
    finally:
        j_sim.build_blocks_world_xml, j_mesh.ASSETS_DIR, xml_tools.ASSETS_DIR = orig


def family_stand_in(env: str):
    """`ycb_stand_in`'s `ycb_dir` and `extra_xml` for a mesh-family env:
    the table setting's tableware and its contact exclusions."""
    from robogym_torch.worlds import rearrange_mesh_family_like as family

    if env == "table_setting":
        return family.TABLEWARE_DIR, family.table_setting_contact_xml()
    return None, None


def mesh_family_world(env: str, files):
    """The JAX Model of `env`'s world ("table_setting", "chessboard",
    "mixture" or "composer"), compiled by the JAX env's `_compile_world`
    inside `ycb_stand_in` on the candidates `files` ({name: [STL path]},
    the env's bank before any filter by name) at the stand-in's slot
    count."""
    import types

    import jax.numpy as jnp

    from robogym_torch.worlds import rearrange_mesh_family_like as family
    from robogym_tpu.envs.rearrange import blocks as j_blocks
    from robogym_tpu.envs.rearrange import composer as j_composer
    from robogym_tpu.envs.rearrange import mesh as j_mesh
    from robogym_tpu.robot import composite as j_comp

    O = family.SLOTS[env]
    sp = j_blocks.RearrangeSimParameters(num_objects=min(O, 5), max_num_objects=O)
    cls, cst = j_mesh.MeshRearrangeEnv, j_mesh.MeshRearrangeEnvConstants()
    if env == "composer":
        cls, cst = j_composer.ComposerRearrangeEnv, j_composer.ComposerEnvConstants()
    shim = types.SimpleNamespace(_mesh_files=files, constants=cst, dtype=jnp.float32)
    return cls._compile_world(shim, sp, j_comp.RobotControlParameters())[0]


def mesh_family_files(env: str):
    """The candidates of `env`'s bank inside `ycb_stand_in`, as the JAX
    env gathers them: the mixture's merged under "<dirname>/<name>"."""
    from robogym_tpu.envs.rearrange import mesh as j_mesh

    if env == "mixture":
        return {f"{d}/{k}": v for d in ("ycb", "geom")
                for k, v in j_mesh.find_meshes_by_dirname(d).items()}
    if env == "table_setting":
        from robogym_tpu.envs.rearrange.table_setting import MESH_NAMES

        return {k: v for k, v in j_mesh.find_meshes_by_dirname("ycb").items()
                if k in MESH_NAMES}
    return j_mesh.find_meshes_by_dirname("chess" if env == "chessboard" else "ycb")


@contextlib.contextmanager
def holdout_stand_in(root: str):
    """Inside, the JAX holdout env composes its world from the stand-in's
    writer (its STLs, and the platform's, under `root`) and reads the
    stand-in holdout's object XMLs and saved states."""
    from robogym_torch.worlds import holdout_ball_like, rearrange_blocks_like
    from robogym_tpu.envs.rearrange import holdout as j_holdout
    from robogym_tpu.envs.rearrange import simulation as j_sim
    from robogym_tpu.mjcf.xml_tools import MjcfXML
    from robogym_tpu.robot import composite as j_comp

    shutil.copy(holdout_ball_like.PLATFORM_STL, root)

    def write(max_num_objects, block_size=0.0254, robot_control_params=None,
              mujoco_timestep=0.001):
        rcp = robot_control_params or j_comp.RobotControlParameters()
        return MjcfXML.from_string(rearrange_blocks_like.write(
            root, max_num_objects, block_size, rcp.is_joint_actuated(), mujoco_timestep))

    orig = j_sim.build_blocks_world_xml, j_holdout.ASSETS_DIR, j_holdout.STATE_DIR
    j_sim.build_blocks_world_xml = write
    j_holdout.ASSETS_DIR, j_holdout.STATE_DIR = holdout_ball_like.DIR, holdout_ball_like.STATE_DIR
    try:
        with sorted_pair_table():
            yield
    finally:
        j_sim.build_blocks_world_xml, j_holdout.ASSETS_DIR, j_holdout.STATE_DIR = orig


@contextlib.contextmanager
def sorted_pair_table():
    """Inside, the JAX compiler finds every pair type of its table. It
    looks a pair up by its two geom types in ascending order, but keys four
    of its entries the other way round (box-cylinder, box-ellipsoid,
    mesh-cylinder, mesh-ellipsoid), so it drops those pairs: a cylinder
    falls through a table. The stand-in holdout's cylinder stands on the
    table, so its world is compiled with the keys in ascending order."""
    from robogym_tpu.mjcf import compiler

    orig = compiler._PAIR_NCON
    compiler._PAIR_NCON = {(min(a, b), max(a, b)): n for (a, b), n in orig.items()}
    try:
        yield
    finally:
        compiler._PAIR_NCON = orig


def j_sim_blocks_world(max_num_objects: int):
    """The JAX package's `build_blocks_world_xml`, as patched by the
    stand-in contexts above."""
    from robogym_tpu.envs.rearrange import simulation as j_sim

    return j_sim.build_blocks_world_xml(max_num_objects)


def compile_snapshot(world: str = "locked_like"):
    """(JAX Model, {key: array}) of the freshly compiled world (float32)."""
    import jax.numpy as jnp

    from robogym_torch.bridge import model_to_numpy
    from robogym_torch.worlds import (blocks_settle_like, dactyl_locked_like, dactyl_reach_like,
                                      holdout_ball_like, locked_like, rearrange_blocks_like,
                                      rearrange_ycb_like, rubik_face_like, rubik_full_like,
                                      table_setting_like)
    from robogym_tpu.envs.rearrange import simulation as sim_lib
    from robogym_tpu.envs.rearrange.dominos import DOMINO_PROPORTIONS
    from robogym_tpu.envs.rearrange.simulation import scale_contact_budgets
    from robogym_tpu.mjcf.compiler import compile_xml
    from robogym_tpu.mjcf.xml_tools import MjcfXML

    if world in COMPOSED:
        with jax_assets_tree():
            model = compile_xml(composed_xml(world), dtype=jnp.float32)
    elif world in MESH_FAMILY:
        from robogym_torch.worlds import rearrange_mesh_family_like as family

        env = MESH_FAMILY[world]
        with tempfile.TemporaryDirectory() as tmp, ycb_stand_in(tmp, *family_stand_in(env)):
            model = mesh_family_world(env, mesh_family_files(env))
    elif world == "rearrange_ycb_like":
        from robogym_tpu.envs.rearrange import mesh as j_mesh

        with tempfile.TemporaryDirectory() as tmp, ycb_stand_in(tmp) as files:
            xml = j_sim_blocks_world(0)
            first = sorted(files)[0]
            for i in range(rearrange_ycb_like.MAX_NUM_OBJECTS):
                xml.append(j_mesh.make_mesh_object_xml(f"object{i}", files[first][0], 1.0))
            model = scale_contact_budgets(compile_xml(xml, dtype=jnp.float32),
                                          rearrange_ycb_like.MAX_NUM_OBJECTS)
    elif world == "holdout_ball_like":
        from robogym_tpu.envs.rearrange import holdout as j_holdout
        from robogym_tpu.utils import jsonnet as j_jsonnet

        sim = j_jsonnet.evaluate_file(holdout_ball_like.CONFIG)["make_env"]["args"][
            "parameters"]["simulation_params"]
        with tempfile.TemporaryDirectory() as tmp, holdout_stand_in(tmp):
            xml = j_sim_blocks_world(0)
            i = 0
            for cfg in sim["task_object_configs"]:
                for _ in range(int(cfg.get("count", 1))):
                    xml.append(j_holdout._load_object_xml(cfg["xml_path"], f"object{i}",
                                                          cfg.get("tag_args", {}),
                                                          cfg.get("material_args", {})))
                    i += 1
            for s_i, cfg in enumerate(sim["scene_object_configs"]):
                for c_i in range(int(cfg.get("count", 1))):
                    xml.append(j_holdout._load_object_xml(cfg["xml_path"], f"scene{s_i}_{c_i}",
                                                          cfg.get("tag_args", {}),
                                                          cfg.get("material_args", {})))
            model = compile_xml(xml, dtype=jnp.float32)
            n_scene = sum(1 for nm in model.const.names["geom"] if nm.startswith("scene"))
            model = scale_contact_budgets(model, i, n_scene)
    elif world == "dactyl_vision_like":
        from robogym_torch.worlds import vision_like

        with tempfile.TemporaryDirectory() as tmp:
            model = compile_xml(vision_like.write_dactyl(tmp), dtype=jnp.float32)
    elif world == "rearrange_vision_like":
        from robogym_torch.worlds import vision_like

        with tempfile.TemporaryDirectory() as tmp:
            model = compile_xml(vision_like.write_rearrange(tmp), dtype=jnp.float32)
        model = scale_contact_budgets(model, rearrange_blocks_like.MAX_NUM_OBJECTS)
    elif world == "blocks_settle_like":
        model = compile_xml(blocks_settle_like.write(), dtype=jnp.float32)
        model = scale_contact_budgets(model, blocks_settle_like.N_BLOCKS)
    elif world == "table_setting_like":
        with tempfile.TemporaryDirectory() as tmp:
            model = compile_xml(table_setting_like.write(tmp), dtype=jnp.float32)
        model = scale_contact_budgets(model, table_setting_like.N_OBJECTS)
    elif world in ("dactyl_locked_like", "rubik_face_like", "rubik_full_like",
                   "dactyl_reach_like"):
        module = {"dactyl_locked_like": dactyl_locked_like, "rubik_face_like": rubik_face_like,
                  "rubik_full_like": rubik_full_like, "dactyl_reach_like": dactyl_reach_like}[world]
        with tempfile.TemporaryDirectory() as tmp:
            model = compile_xml(module.write(tmp), dtype=jnp.float32)
    elif world == "rearrange_settle_like":
        with tempfile.TemporaryDirectory() as tmp:
            main = compile_xml(rearrange_blocks_like.write(tmp), dtype=jnp.float32)
            settle = sim_lib.build_settle_world_xml(main.const._source_xml)
            model = compile_xml(settle, dtype=jnp.float32)
    elif world == "rearrange_dominos_like":
        n = rearrange_blocks_like.MAX_NUM_OBJECTS
        with tempfile.TemporaryDirectory() as tmp:
            xml = MjcfXML.from_string(rearrange_blocks_like.write(tmp, 0))
            for i in range(n):
                xml.append(sim_lib.make_block_xml(
                    f"object{i}", rearrange_blocks_like.BLOCK_HALF * DOMINO_PROPORTIONS))
            model = scale_contact_budgets(compile_xml(xml, dtype=jnp.float32), n)
    elif world in ("rearrange_blocks_like", "rearrange_solver_like", "rearrange_wordblocks_like"):
        main = world != "rearrange_solver_like"
        n = {"rearrange_blocks_like": rearrange_blocks_like.MAX_NUM_OBJECTS,
             "rearrange_wordblocks_like": rearrange_blocks_like.WORDBLOCKS_OBJECTS}.get(world, 0)
        with tempfile.TemporaryDirectory() as tmp:
            model = compile_xml(rearrange_blocks_like.write(tmp, n, joint_actuated=main),
                                dtype=jnp.float32)
        if main:
            model = scale_contact_budgets(model, n)
    else:
        with tempfile.TemporaryDirectory() as tmp:
            xml = locked_like.write(tmp, hand_only=world == "locked_like_hand")
            model = compile_xml(xml, dtype=jnp.float32)
    return model, model_to_numpy(model)


def snapshot_path(world: str) -> str:
    from robogym_torch.worlds import (blocks_settle_like, dactyl_locked_like, dactyl_reach_like,
                                      holdout_ball_like, locked_like, rearrange_blocks_like,
                                      rearrange_mesh_family_like, rearrange_ycb_like,
                                      rubik_face_like, rubik_full_like, table_setting_like)

    if world in MESH_FAMILY:
        return rearrange_mesh_family_like.SNAPSHOTS[MESH_FAMILY[world]]
    if world in COMPOSED:
        return os.path.join(os.path.dirname(rearrange_mesh_family_like.__file__), world + ".npz")
    if world in ("dactyl_vision_like", "rearrange_vision_like"):
        from robogym_torch.worlds import vision_like

        return {"dactyl_vision_like": vision_like.DACTYL_SNAPSHOT,
                "rearrange_vision_like": vision_like.REARRANGE_SNAPSHOT}[world]

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
            "holdout_ball_like": holdout_ball_like.SNAPSHOT}[world]


def main():
    for world in sys.argv[1:] or WORLDS:
        _, arrays = compile_snapshot(world)
        path = snapshot_path(world)
        np.savez_compressed(path, **arrays)
        print(path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
