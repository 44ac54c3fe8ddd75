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
    `compile_solver_world`).

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
          "dactyl_locked_like", "rearrange_blocks_like", "rearrange_solver_like")


def compile_snapshot(world: str = "locked_like"):
    """(JAX Model, {key: array}) of the freshly compiled world (float32)."""
    import jax.numpy as jnp

    from robogym_torch.bridge import model_to_numpy
    from robogym_torch.worlds import (blocks_settle_like, dactyl_locked_like, locked_like,
                                      rearrange_blocks_like, table_setting_like)
    from robogym_tpu.envs.rearrange.simulation import scale_contact_budgets
    from robogym_tpu.mjcf.compiler import compile_xml

    if world == "blocks_settle_like":
        model = compile_xml(blocks_settle_like.write(), dtype=jnp.float32)
        model = scale_contact_budgets(model, blocks_settle_like.N_BLOCKS)
    elif world == "table_setting_like":
        with tempfile.TemporaryDirectory() as tmp:
            model = compile_xml(table_setting_like.write(tmp), dtype=jnp.float32)
        model = scale_contact_budgets(model, table_setting_like.N_OBJECTS)
    elif world == "dactyl_locked_like":
        with tempfile.TemporaryDirectory() as tmp:
            model = compile_xml(dactyl_locked_like.write(tmp), dtype=jnp.float32)
    elif world in ("rearrange_blocks_like", "rearrange_solver_like"):
        main = world == "rearrange_blocks_like"
        n = rearrange_blocks_like.MAX_NUM_OBJECTS if main else 0
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
    from robogym_torch.worlds import (blocks_settle_like, dactyl_locked_like, locked_like,
                                      rearrange_blocks_like, table_setting_like)

    return {"locked_like": locked_like.SNAPSHOT, "locked_like_hand": locked_like.HAND_SNAPSHOT,
            "blocks_settle_like": blocks_settle_like.SNAPSHOT,
            "table_setting_like": table_setting_like.SNAPSHOT,
            "dactyl_locked_like": dactyl_locked_like.SNAPSHOT,
            "rearrange_blocks_like": rearrange_blocks_like.SNAPSHOT,
            "rearrange_solver_like": rearrange_blocks_like.SOLVER_SNAPSHOT}[world]


def main():
    for world in sys.argv[1:] or WORLDS:
        _, arrays = compile_snapshot(world)
        path = snapshot_path(world)
        np.savez_compressed(path, **arrays)
        print(path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main()
