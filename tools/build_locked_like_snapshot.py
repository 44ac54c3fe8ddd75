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
    `compile_xml`, the default contact budgets.

    JAX_PLATFORMS=cpu python tools/build_locked_like_snapshot.py [WORLD ...]

The port loads a snapshot with `robogym_torch.bridge.model_from_numpy`; a
test rebuilds each and checks that it matches the committed file field by
field.
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

WORLDS = ("locked_like", "locked_like_hand", "blocks_settle_like", "table_setting_like",
          "dactyl_locked_like", "rearrange_blocks_like", "rearrange_solver_like",
          "rearrange_settle_like", "rearrange_dominos_like", "rearrange_wordblocks_like",
          "rubik_face_like", "rubik_full_like", "dactyl_reach_like")


def compile_snapshot(world: str = "locked_like"):
    """(JAX Model, {key: array}) of the freshly compiled world (float32)."""
    import jax.numpy as jnp

    from robogym_torch.bridge import model_to_numpy
    from robogym_torch.worlds import (blocks_settle_like, dactyl_locked_like, dactyl_reach_like,
                                      locked_like, rearrange_blocks_like, rubik_face_like,
                                      rubik_full_like, table_setting_like)
    from robogym_tpu.envs.rearrange import simulation as sim_lib
    from robogym_tpu.envs.rearrange.dominos import DOMINO_PROPORTIONS
    from robogym_tpu.envs.rearrange.simulation import scale_contact_budgets
    from robogym_tpu.mjcf.compiler import compile_xml
    from robogym_tpu.mjcf.xml_tools import MjcfXML

    if world == "blocks_settle_like":
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
                                      locked_like, rearrange_blocks_like, rubik_face_like,
                                      rubik_full_like, table_setting_like)

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
            "dactyl_reach_like": dactyl_reach_like.SNAPSHOT}[world]


def main():
    for world in sys.argv[1:] or WORLDS:
        _, arrays = compile_snapshot(world)
        path = snapshot_path(world)
        np.savez_compressed(path, **arrays)
        print(path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
