"""The port's packed contact table against the JAX package's, on BALL_BOX
(tests/test_constraint_batched.py), on the locked-like world and on the
table-setting world at B=4, and the static pair grouping and slot layout
against the JAX package's on every world.

Both packages run their own position pass on the same state, so the
broadphase scores agree to float32 rounding before both round them to
bfloat16. Each group's chosen pairs are compared as sets (a tie of bf16
scores may order them differently); the table is compared after sorting
each group's block by pair. Ids, condim and wtab must be equal; dist, pos
and normal of live contacts agree to 1e-5 abs (the narrowphase repeats the
same float32 formulas)."""

import jax
import numpy as np
import pytest

from _torch_common import (ball_box_models, ball_box_state, locked_like_models,
                           locked_like_state, settle_state, snapshot_jax_model, snapshot_model,
                           to_jax)
from robogym_torch import bridge
from robogym_torch.physics import step as t_step
from robogym_torch.physics.collision import driver as t_driver
from robogym_torch.worlds import blocks_settle_like, locked_like, table_setting_like
from robogym_tpu.physics import step as j_step

BIG = 1e10


def _sorted_blocks(tab, groups):
    """Per env, each group's slots reordered by (geom1, geom2); the wtab
    rows (one per chosen pair) in the same order."""
    B = tab["contact.dist"].shape[0]
    perm, wperm = [], []
    base = wbase = 0
    for g in groups:
        K, ncon = g["K"], g["ncon"]
        key = (tab["contact.geom1"][:, base:base + K * ncon:ncon].astype(np.int64) * 10000
               + tab["contact.geom2"][:, base:base + K * ncon:ncon])
        order = np.argsort(key, axis=1, kind="stable")                        # (B, K)
        perm.append(base + (order[:, :, None] * ncon + np.arange(ncon)).reshape(B, -1))
        wperm.append(wbase + order)
        base += K * ncon
        wbase += K
    perm, wperm = np.concatenate(perm, 1), np.concatenate(wperm, 1)
    out = {}
    for k, v in tab.items():
        if k.startswith("contact."):
            idx = wperm if k == "contact.wtab" else perm
            out[k] = np.take_along_axis(v, idx.reshape(idx.shape + (1,) * (v.ndim - 2)), 1)
    return out


def _compare_tables(tm, jd, td):
    groups = t_driver.build_groups(tm.const, tm.opt.group_cap)
    j = _sorted_blocks(bridge.data_to_numpy(jd), groups)
    t = _sorted_blocks(bridge.data_to_numpy(td), groups)
    for k in ("geom1", "geom2", "body1", "body2", "condim", "active", "wtab"):
        np.testing.assert_array_equal(t["contact." + k], j["contact." + k], err_msg=k)
    live = j["contact.active"]
    assert live.any(), "no live contact in the state"
    assert np.array_equal(t["contact.dist"] >= BIG / 2, j["contact.dist"] >= BIG / 2)
    for k in ("dist", "includemargin"):
        np.testing.assert_allclose(t["contact." + k][live], j["contact." + k][live],
                                   rtol=0, atol=1e-5, err_msg=k)
    for k in ("pos", "normal"):
        np.testing.assert_allclose(t["contact." + k][live], j["contact." + k][live],
                                   rtol=0, atol=1e-5, err_msg=k)


def _run(jmod, tm, d):
    jd = jax.jit(jax.vmap(lambda x: j_step.fwd_position(jmod, x)))(to_jax(d))
    td = t_step.fwd_position(tm, d)
    _compare_tables(tm, jd, td)


def test_contact_table_matches_jax_ball_box():
    jmod, tm = ball_box_models()
    _run(jmod, tm, ball_box_state(tm, 3))


@pytest.mark.parametrize("seed", [0, 1])
def test_contact_table_matches_jax_locked_like(seed):
    jmod, tm = locked_like_models()
    _run(jmod, tm, locked_like_state(tm, 4, seed=seed))


def test_contact_table_matches_jax_table_setting():
    """The table-setting world (five free meshes on the table top, the spoon
    on the plate in the odd envs) after 40 substeps: box-mesh, mesh-mesh
    and plane-mesh slots."""
    tm, d = settle_state(4, world=table_setting_like)
    _run(snapshot_jax_model(table_setting_like.SNAPSHOT), tm, d)


@pytest.mark.parametrize("world", ["locked_like", "locked_like_hand", "blocks_settle_like",
                                   "table_setting_like"])
def test_pair_groups_and_slot_layout_match_jax(world):
    """`build_groups` at the model's group cap: the same groups in the same
    order (kind, geom types, contacts per pair, active budget K, geom ids,
    condim), hence the same contact slot layout and winner rows as the JAX
    package's `driver.build_groups`."""
    from robogym_tpu.physics.collision import driver as j_driver

    path = {"locked_like": locked_like.SNAPSHOT, "locked_like_hand": locked_like.HAND_SNAPSHOT,
            "blocks_settle_like": blocks_settle_like.SNAPSHOT,
            "table_setting_like": table_setting_like.SNAPSHOT}[world]
    tm, jmod = snapshot_model(path), snapshot_jax_model(path)
    cap = tm.opt.group_cap
    assert cap == jmod.opt.group_cap
    got, want = t_driver.build_groups(tm.const, cap), j_driver.build_groups(jmod.const, cap)
    assert [(g["kind"], g["t1"], g["t2"], g["ncon"], g["K"]) for g in got] == \
        [(g["kind"], g["t1"], g["t2"], g["ncon"], g["K"]) for g in want]
    for g, w in zip(got, want):
        for k in ("g1", "g2", "condim"):
            np.testing.assert_array_equal(g[k], w[k])
    assert t_driver.contact_slot_layout(tm.const, cap) == \
        list(j_driver.contact_slot_layout(jmod.const, cap))
    np.testing.assert_array_equal(t_driver.slot_winner_rows(tm.const, cap),
                                  j_driver.slot_winner_rows(jmod.const, cap))
    if world == "table_setting_like":
        kinds = [(g["kind"], len(g["g1"]), g["ncon"], g["K"]) for g in got]
        assert kinds == [("box_convex", 5, 4, 5), ("convex", 10, 4, 10),
                         ("plane_convex", 10, 4, 9)]


def test_deepest_k_breaks_bf16_ties_as_top_k():
    """Scores that tie once rounded to bfloat16 (and exact ties) rank as
    `lax.top_k` ranks them: toward the lower pair index."""
    import jax.numpy as jnp
    import torch

    rng = np.random.default_rng(4)
    base = rng.choice(np.asarray([-0.5, -0.02, 0.0, 0.01, 0.3], np.float32), (6, 40))
    score = base * (1.0 + 1e-4 * rng.standard_normal(base.shape).astype(np.float32))
    for K in (1, 8, 17):
        want_v, want_i = jax.lax.top_k(jnp.asarray(score).astype(jnp.bfloat16), K)
        sel, live = t_driver.deepest_k(torch.as_tensor(score), K)
        np.testing.assert_array_equal(sel.numpy(), np.asarray(want_i))
        np.testing.assert_array_equal(live.numpy(), np.asarray(want_v > 0))


def test_contact_pick_breaks_ties_as_top_k():
    """The constraint prelude's pick of the deepest slots: inactive slots
    all score BIG and live slots may tie; the order must be lax.top_k's
    (lower slot index first), slot for slot."""
    import jax.numpy as jnp
    import torch

    from robogym_torch.physics import constraint as t_con
    from robogym_tpu.physics import constraint as j_con

    jmod, tm = ball_box_models()
    d = t_step.fwd_position(tm, ball_box_state(tm, 1, settle=0))
    ncon = d.contact.dist.shape[1]
    dist = np.asarray([-0.01, 0.02, -0.01, 0.5, -0.01, 0.0, 0.0, -0.02, 0.3, -0.01][:ncon],
                      np.float32)[None]
    active = np.asarray([1, 0, 1, 0, 1, 1, 1, 1, 0, 1][:ncon], bool)[None]
    con = d.contact.replace(dist=torch.as_tensor(dist), active=torch.as_tensor(active),
                            includemargin=torch.zeros_like(d.contact.includemargin))
    d = d.replace(contact=con)
    sel = t_con._post_gather_prelude(tm, d)[1]
    jd = jax.tree_util.tree_map(lambda x: x[0], to_jax(d))
    oh = j_con._post_gather_prelude(jmod, jd)[1]
    np.testing.assert_array_equal(sel.numpy()[0], np.argmax(np.asarray(oh), axis=-1))


PRIMITIVES = ["plane_sphere", "plane_capsule", "plane_box", "plane_cylinder", "plane_ellipsoid",
              "sphere_sphere", "sphere_capsule", "sphere_box", "capsule_capsule", "capsule_box"]


def _rotations(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(n, 3, 3).astype(np.float32)


@pytest.mark.parametrize("name", PRIMITIVES)
def test_primitive_matches_jax(name):
    """Each analytic collider of the port against the JAX package's on 64
    seeded pairs a few cm apart (or a plane and a geom near it): dist, pos
    and normal of every live candidate to 1e-5 abs."""
    import jax.numpy as jnp
    import torch

    from robogym_torch.physics.collision import primitives as t_prim
    from robogym_tpu.physics.collision import primitives as j_prim

    rng = np.random.default_rng(PRIMITIVES.index(name))
    n = 64
    xm1, xm2 = _rotations(rng, n), _rotations(rng, n)
    s1 = rng.uniform(0.02, 0.06, (n, 3)).astype(np.float32)
    s2 = rng.uniform(0.02, 0.06, (n, 3)).astype(np.float32)
    xp1 = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    u = rng.standard_normal((n, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    if name.startswith("plane"):
        xm1 = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
        u = np.tile([0.0, 0.0, 1.0], (n, 1))
    xp2 = (xp1 + u * rng.uniform(0.0, 0.1, (n, 1))).astype(np.float32)
    args = (xp1, xm1, s1, xp2, xm2, s2)
    want = jax.vmap(getattr(j_prim, name))(*[jnp.asarray(a) for a in args])
    got = getattr(t_prim, name)(*[torch.as_tensor(a) for a in args])
    dist_w = np.asarray(want[0])
    live = dist_w < BIG / 2
    np.testing.assert_array_equal(got[0].numpy() < BIG / 2, live)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[live], np.asarray(w)[live], rtol=0, atol=1e-5)


SUPPORTS = ["hull", "box", "sphere", "capsule", "cylinder", "ellipsoid"]


@pytest.mark.parametrize("kind", SUPPORTS)
def test_support_matches_jax(kind):
    """Each support function of the port against the JAX package's, on 32
    seeded poses and 42 directions (DIRS42): the support point to 1e-6 abs.
    The port's functions are batched over leading axes; JAX's are vmapped."""
    import jax.numpy as jnp
    import torch

    from robogym_torch.physics.collision import convex as t_cvx
    from robogym_tpu.physics.collision import convex as j_cvx

    np.testing.assert_array_equal(t_cvx.DIRS12, j_cvx.DIRS12)
    np.testing.assert_array_equal(t_cvx.DIRS42, j_cvx.DIRS42)
    rng = np.random.default_rng(SUPPORTS.index(kind))
    n = 32
    xpos = rng.uniform(-0.1, 0.1, (n, 3)).astype(np.float32)
    xmat = _rotations(rng, n)
    size = rng.uniform(0.02, 0.06, (n, 3)).astype(np.float32)
    verts = rng.uniform(-0.05, 0.05, (n, 16, 3)).astype(np.float32)
    mask = (np.arange(16) < rng.integers(4, 17, n)[:, None]).astype(np.float32)
    args = {"hull": (xpos, xmat, verts, mask), "sphere": (xpos, size[:, 0])}.get(
        kind, (xpos, xmat, size))
    make = "make_%s_support" % kind
    dirs = np.broadcast_to(j_cvx.DIRS42, (n, 42, 3))

    def jax_one(*a):
        sup = getattr(j_cvx, make)(*a[:-1])
        return jax.vmap(sup)(a[-1])

    want = jax.vmap(jax_one)(*[jnp.asarray(a) for a in args], jnp.asarray(dirs))
    t_args = [torch.as_tensor(a)[:, None] for a in args]
    got = getattr(t_cvx, make)(*t_args)(torch.as_tensor(dirs.copy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_broadphase_scores_match_jax():
    """Every pair group's capsule broadphase scores on the locked-like world
    at B=4, to 1e-5 abs: the same float32 formulas on the same poses."""
    from robogym_tpu.physics.collision import driver as j_driver

    jmod, tm = locked_like_models()
    d = t_step.fwd_position(tm, locked_like_state(tm, 4, seed=2, settle=4))
    want = jax.jit(jax.vmap(lambda x: j_driver.broadphase_scores(jmod, x)))(to_jax(d))
    got = t_driver.broadphase_scores(tm, d)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5)
