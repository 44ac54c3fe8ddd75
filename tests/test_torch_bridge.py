"""The port's model bridge: the committed snapshots against a fresh
compile, bit-equal round trips, and the port's import isolation."""

import importlib.util
import os
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _torch_common import (ball_box_models, jax_data_from_numpy, jax_model_from_numpy,
                           locked_like_arrays)
from robogym_torch import bridge
from robogym_torch.worlds import blocks_settle_like, locked_like
from robogym_tpu.envs.rearrange.simulation import scale_contact_budgets
from robogym_tpu.mjcf.compiler import compile_xml
from robogym_tpu.mjcf.model import make_data as jax_make_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same(a, b):
    assert sorted(a) == sorted(b), set(a) ^ set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, (k, x.dtype, y.dtype, x.shape, y.shape)
        assert np.array_equal(x, y), k


def test_snapshot_matches_fresh_compile():
    """The committed npz equals a fresh JAX compile of locked_like.py field
    by field, so it cannot drift from its source (exact: same compiler,
    same float32 casts)."""
    with tempfile.TemporaryDirectory() as tmp:
        model = compile_xml(locked_like.write(tmp), dtype=jnp.float32)
    fresh = bridge.model_to_numpy(model)
    _assert_same(fresh, locked_like_arrays())
    c = model.const
    assert (c.nq, c.nv, c.nu, c.ntendon) == (31, 30, 20, 4)


def _snapshot_tool():
    spec = importlib.util.spec_from_file_location(
        "build_locked_like_snapshot", os.path.join(REPO, "tools", "build_locked_like_snapshot.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


@pytest.mark.parametrize("world", ["locked_like_hand", "blocks_settle_like", "table_setting_like",
                                   "dactyl_locked_like", "rearrange_blocks_like",
                                   "rearrange_solver_like", "rearrange_settle_like",
                                   "rearrange_dominos_like", "rearrange_wordblocks_like",
                                   "rubik_face_like", "rubik_full_like", "dactyl_reach_like"])
def test_world_snapshot_matches_fresh_compile(world):
    """The hand-only and goal-settle snapshots equal what
    tools/build_locked_like_snapshot.py compiles now, field by field. The
    hand has no collision pair and 24 hinges; the settle worlds carry the
    contact budgets of `scale_contact_budgets(model, 5)`: the blocks world
    15 box-box and 5 plane-box pairs, the table-setting world five meshes of
    64 hull verts each and 25 pairs (5 box-mesh, 10 mesh-mesh, 10
    plane-mesh). The dactyl-shaped world has nq = 38 and nv = 36 (24
    hinges; the cube's and the target's three slides and a ball) and one
    box-box pair, palm and cube. The rearrange worlds: the main one nv = 60
    (6 arm hinges, 6 gripper hinges, 8 free blocks), 7 actuators, a joint
    and two connect equalities, and the budgets of
    `scale_contact_budgets(model, 8)`; the solver one nv = 12, the gripper's
    actuator only, and the mocap weld besides; the settle world of the main
    one floor, table and 8 blocks (nv = 48, no actuator, no equality, no
    mesh) with the default budgets; the dominos world the main one's
    structure with blocks of half-size 0.0254 x (0.2, 1, 2); wordblocks'
    the main one at 6 blocks (nv = 48) with the budgets of
    `scale_contact_budgets(model, 6)`. The cubelet world has nq = 49 and
    nv = 48 (24 hinges; the cube's three slides and ball; 18 cubelet
    hinges, 16 of them held to the 2 drivers by joint equality rows), 26
    box cubelets and a box palm, and the default budgets. The 20-cubelet
    world has nq = 97 and nv = 96 (24 hinges; the cube's three slides and
    ball; 6 face drivers and 20 cubelets on three hinges each, all 66 with
    friction loss, no equality), 26 box pieces and a box palm, and the
    default budgets. The reach world has the hand alone (nq = nv = 24, 20
    force-limited actuators, 4 tendons), its palm at the mount pose's
    (1, 1.5, 0.15), five target sites, one box (the palm) and the default
    budgets."""
    tool = _snapshot_tool()
    model, fresh = tool.compile_snapshot(world)
    with np.load(tool.snapshot_path(world)) as z:
        _assert_same(fresh, {k: z[k] for k in z.files})
    c = model.const
    if world == "locked_like_hand":
        assert (c.nq, c.nv, len(c.collision_pairs)) == (24, 24, 0)
        return
    if world.startswith("rearrange_"):
        from robogym_torch.mjcf.model import EqType

        eq = sorted(int(t) for t in c.eq_type)
        if world in ("rearrange_blocks_like", "rearrange_dominos_like"):
            assert (c.nq, c.nv, c.nu, c.nmocap) == (68, 60, 7, 1)
            assert eq == sorted([EqType.JOINT, EqType.CONNECT, EqType.CONNECT])
            assert (int(fresh["opt.ncon_active"]), int(fresh["opt.group_cap"])) == (56, 64)
            half = fresh["model.geom_size"][c.names["geom"]["object7"]]
            want = 0.0254 * (np.array([0.2, 1.0, 2.0]) if "dominos" in world else np.ones(3))
            np.testing.assert_allclose(half, want, rtol=1e-6)
        elif world == "rearrange_settle_like":
            assert (c.nq, c.nv, c.nu, c.neq, c.nmesh, c.nmocap) == (56, 48, 0, 0, 0, 0)
            assert (int(fresh["opt.ncon_active"]), int(fresh["opt.group_cap"])) == (32, 48)
        elif world == "rearrange_wordblocks_like":
            assert (c.nq, c.nv, c.nu) == (54, 48, 7) and "object6" not in c.names["body"]
            assert (int(fresh["opt.ncon_active"]), int(fresh["opt.group_cap"])) == (48, 56)
        else:
            assert (c.nq, c.nv, c.nu, c.nmocap) == (12, 12, 1, 1)
            assert eq == sorted([EqType.JOINT, EqType.CONNECT, EqType.CONNECT, EqType.WELD])
        return
    if world == "rubik_face_like":
        from robogym_torch.mjcf.model import EqType

        boxes = np.flatnonzero(np.asarray(c.geom_type) == 6)
        assert (c.nq, c.nv, c.nu, c.ntendon, len(boxes)) == (49, 48, 20, 4, 27)
        assert sorted(int(t) for t in c.eq_type) == [EqType.JOINT] * 16
        assert (int(fresh["opt.ncon_active"]), int(fresh["opt.group_cap"])) == (32, 48)
        return
    if world == "rubik_full_like":
        boxes = np.flatnonzero(np.asarray(c.geom_type) == 6)
        assert (c.nq, c.nv, c.nu, c.ntendon, c.neq, len(boxes)) == (97, 96, 20, 4, 0, 27)
        assert np.count_nonzero(fresh["model.dof_frictionloss"]) == 66
        assert (int(fresh["opt.ncon_active"]), int(fresh["opt.group_cap"])) == (32, 48)
        return
    if world == "dactyl_reach_like":
        boxes = np.flatnonzero(np.asarray(c.geom_type) == 6)
        assert (c.nq, c.nv, c.nu, c.ntendon, len(boxes)) == (24, 24, 20, 4, 1)
        assert np.asarray(c.actuator_forcelimited).all()
        assert sum(n.startswith("target:") for n in c.names["site"]) == 5
        assert (int(fresh["opt.ncon_active"]), int(fresh["opt.group_cap"])) == (32, 48)
        return
    if world == "dactyl_locked_like":
        boxes = np.flatnonzero(np.asarray(c.geom_type) == 6)
        box_pairs = [p for p in np.asarray(c.collision_pairs)[:, :2].tolist()
                     if set(p) <= set(boxes.tolist())]
        assert (c.nq, c.nv, c.nu, c.ntendon, len(box_pairs)) == (38, 36, 20, 4, 1)
        return
    assert (int(fresh["opt.ncon_active"]), int(fresh["opt.group_cap"])) == (48, 56)
    if world == "table_setting_like":
        assert (c.nq, c.nv, c.nmesh, len(c.collision_pairs)) == (35, 30, 5, 25)
        assert (np.asarray(fresh["model.mesh_convex_mask"]).sum(1) == 64).all()
        return
    raw = compile_xml(blocks_settle_like.write(), dtype=jnp.float32)
    scaled = scale_contact_budgets(raw, blocks_settle_like.N_BLOCKS)
    assert (scaled.opt.ncon_active, scaled.opt.group_cap) == (48, 56)
    assert (c.nq, c.nv, len(c.collision_pairs)) == (35, 30, 20)


def test_model_round_trip_is_bit_equal():
    """JAX -> numpy -> torch -> numpy, and numpy -> JAX -> numpy."""
    arrays = locked_like_arrays()
    tm = bridge.model_from_numpy(arrays, "cpu")
    _assert_same(bridge.model_to_numpy(tm), arrays)
    _assert_same(bridge.model_to_numpy(jax_model_from_numpy(arrays)), arrays)


def test_data_round_trip_is_bit_equal():
    jmod, _ = ball_box_models()
    rng = np.random.default_rng(0)
    d0 = jax_make_data(jmod, dtype=jnp.float32)
    d = jax.tree_util.tree_map(lambda x: jnp.stack([x] * 3), d0)
    d = d.replace(qpos=jnp.asarray(rng.standard_normal(d.qpos.shape).astype(np.float32)),
                  qvel=jnp.asarray(rng.standard_normal(d.qvel.shape).astype(np.float32)))
    arrays = bridge.data_to_numpy(d)
    td = bridge.data_from_numpy(arrays, "cpu")
    _assert_same(bridge.data_to_numpy(td), arrays)
    _assert_same(bridge.data_to_numpy(jax_data_from_numpy(bridge.data_to_numpy(td))), arrays)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import robogym_torch, robogym_torch.bridge, robogym_torch.cuda\n"
        "import robogym_torch.physics.step, robogym_torch.physics.cg_kernel\n"
        "import robogym_torch.physics.factor_kernel, robogym_torch.physics.setconst\n"
        "import robogym_torch.physics.collision.convex_kernel\n"
        "import robogym_torch.physics.collision.boxbox_kernel\n"
        "import robogym_torch.physics.constraint, robogym_torch.physics.constraint_batched\n"
        "import robogym_torch.worlds.locked_like, robogym_torch.worlds.blocks_settle_like\n"
        "import robogym_torch.worlds.table_setting_like, robogym_torch.worlds.dactyl_locked_like\n"
        "import robogym_torch.envs.core, robogym_torch.envs.dactyl.cube_env\n"
        "import robogym_torch.envs.dactyl.locked, robogym_torch.robot.shadow_hand\n"
        "import robogym_torch.utils.rotation, robogym_torch.worlds.rearrange_blocks_like\n"
        "import robogym_torch.envs.rearrange.blocks, robogym_torch.envs.rearrange.goals\n"
        "import robogym_torch.envs.rearrange.simulation, robogym_torch.robot.composite\n"
        "import robogym_torch.robot.gripper, robogym_torch.robot.ur16e\n"
        "import robogym_torch.robot.tcp_solver, robogym_torch.robot.tcp_force_limiter\n"
        "import robogym_torch.envs.dactyl.face_perpendicular, robogym_torch.wrappers.face\n"
        "import robogym_torch.worlds.rubik_face_like, robogym_torch.wrappers\n"
        "import robogym_torch.envs.dactyl.full_perpendicular, robogym_torch.wrappers.parametric\n"
        "import robogym_torch.envs.dactyl.cube_manipulator, robogym_torch.envs.dactyl.goals_solver\n"
        "import robogym_torch.utils.rubik_utils, robogym_torch.worlds.rubik_full_like\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'robogym_tpu'))]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO, env=env, timeout=120)
