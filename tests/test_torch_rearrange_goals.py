"""The port's rearrange goal classes, placement masks and masked
observations against the JAX package's, on the CPU, without physics.

The goal classes (train, reach, deterministic reach, stack in both orders,
pick-and-place, the fixed placements of wordblocks, dominos, attached) run
on the committed UR16e-shaped worlds' indices (`rearrange_blocks_like.npz`,
8 object slots; wordblocks' `rearrange_wordblocks_like.npz`, 6), each
through the bridge into both packages, at B=16 envs whose objects sit at
seeded poses on and above the table. The JAX generator runs under
`jax.vmap` on the JAX keys; the port's on the draws those keys give (the
same `jax.random` call on the same split key, in the dtype the JAX call
uses: float64 where it names none, as conftest turns x64 on; where the JAX
package draws twice from one key, both draws come from it).

Tolerances: `next_goal`'s fields 1e-6 abs (float32 arithmetic on the same
draws, in the same order), its integer and boolean fields exactly;
`goal_distance` and `relative_goal` 1e-5 abs (float32 formulas in another
order), on goals that carry duplicate-object groups; the hard and the soft
placement mask and the masked observations exactly (selects and products
by 0 or 1 of the same float32 values)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import snapshot_jax_model, snapshot_model
from robogym_torch import bridge
from robogym_torch.envs.rearrange import blocks as t_blocks
from robogym_torch.envs.rearrange import blocks_attached as t_attached
from robogym_torch.envs.rearrange import goals as t_goals
from robogym_torch.envs.rearrange import simulation as t_sim
from robogym_torch.envs.rearrange import wordblocks as t_word
from robogym_torch.robot import composite as t_comp
from robogym_torch.worlds import rearrange_blocks_like
from robogym_tpu.envs.rearrange import blocks as j_blocks
from robogym_tpu.envs.rearrange import blocks_attached as j_attached
from robogym_tpu.envs.rearrange import goals as j_goals
from robogym_tpu.envs.rearrange import simulation as j_sim
from robogym_tpu.mjcf import model as j_model
from robogym_tpu.robot import composite as j_comp
from robogym_tpu.utils import rotation as j_rot

B = 16
C = t_goals.N_CANDIDATES


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got).astype(np.float64), np.asarray(want, np.float64), rtol=0,
                               atol=tol, err_msg=msg)


class World:
    """Both packages' model, object index and arm index of a snapshot, and
    seeded states: objects within 0.1 m of the placement area, up to 0.3 m
    above the table, at random rotations; the TCP above the table."""

    def __init__(self, path, seed):
        self.jm, self.tm = snapshot_jax_model(path), snapshot_model(path)
        self.O = int(sum(k.startswith("object") for k in self.tm.const.names["body"]))
        self.jidx = j_sim.RearrangeIndex.build(self.jm, self.O)
        self.tidx = t_sim.RearrangeIndex.build(self.tm, self.O)
        self.jarm = j_comp.CompositeIndex.build(self.jm, j_comp.RobotControlParameters()).arm
        self.tarm = t_comp.CompositeIndex.build(self.tm, t_comp.RobotControlParameters()).arm
        rng = np.random.default_rng(seed)
        lo, hi = self.jidx.placement_bounds(self.O)
        jd = jax.vmap(lambda _: j_model.make_data(self.jm))(jnp.arange(B))
        qpos = np.asarray(jd.qpos).copy()
        for i, a in enumerate(self.jidx.object_qpos_adr):
            qpos[:, a:a + 2] = rng.uniform(lo[:2] - 0.1, hi[:2] + 0.1, (B, 2))
            qpos[:, a + 2] = hi[2] - 0.26 + rng.uniform(0.0, 0.3, B)
            q = rng.standard_normal((B, 4))
            qpos[:, a + 3:a + 7] = q / np.linalg.norm(q, axis=1, keepdims=True)
        xpos = np.asarray(jd.xpos).copy()
        xpos[:, self.jarm.tcp_body_id] = rng.uniform([-0.2, -0.4, 0.45], [0.4, 0.4, 0.8], (B, 3))
        self.jd = jd.replace(qpos=jnp.asarray(qpos, jnp.float32),
                             xpos=jnp.asarray(xpos, jnp.float32))
        self.td = bridge.data_from_numpy(bridge.data_to_numpy(self.jd), "cpu")


@pytest.fixture(scope="module")
def main_world():
    return World(rearrange_blocks_like.SNAPSHOT, 0)


@pytest.fixture(scope="module")
def word_world():
    return World(rearrange_blocks_like.WORDBLOCKS_SNAPSHOT, 1)


# ---------------------------------------------------------------------------
# the draws of each class from its JAX key
# ---------------------------------------------------------------------------

def _u(key, shape=()):
    return np.asarray(jax.random.uniform(key, shape, jnp.float32))


def _state_draws(key, n, O, args):
    """ObjectStateGoal.next_goal's (goals.py:245): candidates per object,
    rotations per object."""
    k_pos, k_rot = jax.random.split(key)
    out = {"pos_u": np.stack([_u(k, (C, 2)) for k in jax.random.split(k_pos, O)]), "rot_u": None}
    if args.randomize_goal_rot:
        keys = jax.random.split(k_rot, O)
        if args.rot_randomize_type == "z_axis":
            out["rot_u"] = np.asarray([jax.random.uniform(k, ()) for k in keys])
        else:
            out["rot_u"] = np.stack([np.asarray([jax.random.uniform(kk) for kk in
                                                 jax.random.split(k, 3)]) for k in keys])
    return out


def _train_draws(key, n, O, args):
    """TrainStateGoal.next_goal's (goals.py:318-342): the lift height and
    the lifted object both from k_lift."""
    k_base, k_p, k_lift, k_tower, k_order = jax.random.split(key, 5)
    return dict(_state_draws(k_base, n, O, args), p_u=_u(k_p), lift_u=_u(k_lift),
                target_i=np.asarray(jax.random.randint(k_lift, (), 0, n)),
                tower_size=np.asarray(jax.random.randint(k_tower, (), 2, max(n, 2) + 1)),
                order=np.asarray(jax.random.permutation(k_order, O)))


def _det_reach_draws(key, n, O, args):
    """DeterministicReachGoal's: the pool index from the same key."""
    return dict(_state_draws(key, n, O, args),
                pool_i=np.asarray(jax.random.randint(key, (), 0, 2)))


def _stack_draws(key, n, O, args):
    k_base, k_order = jax.random.split(key)
    return dict(_state_draws(k_base, n, O, args),
                order=np.asarray(jax.random.permutation(k_order, O)))


def _pickandplace_draws(key, n, O, args):
    k1, k2 = jax.random.split(key)
    return dict(_state_draws(k1, n, O, args), lift_u=_u(k2))


def _domino_draws(key, n, O, args):
    k_ang, k_off = jax.random.split(key)
    return {"ang_u": _u(k_ang), "off_u": _u(k_off, (2,))}


def _attached_draws(key, n, O, args):
    k_perm, k_off = jax.random.split(key)
    return {"perm": np.asarray(jax.random.permutation(k_perm, O)), "off_u": _u(k_off, (2,))}


def batch_draws(fn, keys, n, O, args):
    """The port's draws for B envs: `fn`'s per key, stacked."""
    per = [fn(k, n, O, args) for k in keys]
    return {k: None if per[0][k] is None else torch.as_tensor(np.stack([p[k] for p in per]))
            for k in per[0]}


# ---------------------------------------------------------------------------
# the goal classes
# ---------------------------------------------------------------------------

def _word_pair(w, args):
    """wordblocks' fixed row (wordblocks.py:52-60) in both packages."""
    O = w.O
    rel = np.stack([np.linspace(0.2, 0.8, O), np.full(O, 0.5)], axis=1)
    quats = np.tile(np.asarray([[1.0, 0, 0, 0]]), (O, 1))
    tilt = np.asarray(j_rot.quat_from_angle_and_axis(jnp.asarray(0.38), jnp.asarray([0.0, 0, 1.0])))
    quats[4] = quats[5] = tilt
    return (j_goals.ObjectFixedStateGoal(w.jidx, j_goals.GoalArgs(), relative_placements=rel,
                                         init_quats=quats),
            t_word.goal_generator(w.tidx))


TRAIN = dict(pickup_proba=0.3, stacking_proba=0.3)
# name: (world, GoalArgs keywords, (JAX generator, port generator) of (world, args),
#        draws, objects in use, per-env object sizes, half-size scale)
CASES = {
    "train": ("main", TRAIN, lambda w, a: (
        j_goals.TrainStateGoal(w.jidx, a, goal_distance_ratio=0.7),
        t_goals.TrainStateGoal(w.tidx, t_goals.GoalArgs(**TRAIN), goal_distance_ratio=0.7)),
        _train_draws, 5, True, 1.0),
    "train-all-objects": ("main", dict(pickup_proba=0.4, stacking_proba=0.5), lambda w, a: (
        j_goals.TrainStateGoal(w.jidx, a),
        t_goals.TrainStateGoal(w.tidx, t_goals.GoalArgs(pickup_proba=0.4, stacking_proba=0.5))),
        _train_draws, 8, False, 1.0),
    "reach": ("main", {}, lambda w, a: (j_goals.ObjectReachGoal(w.jidx, w.jarm, a),
                                        t_goals.ObjectReachGoal(w.tidx, w.tarm)),
              _state_draws, 1, False, 1.0),
    "det-reach": ("main", {}, lambda w, a: (j_goals.DeterministicReachGoal(w.jidx, w.jarm, a),
                                            t_goals.DeterministicReachGoal(w.tidx, w.tarm)),
                  _det_reach_draws, 1, False, 1.0),
    "stack": ("main", dict(randomize_goal_rot=True), lambda w, a: (
        j_goals.ObjectStackGoal(w.jidx, a, fixed_order=False),
        t_goals.ObjectStackGoal(w.tidx, t_goals.GoalArgs(randomize_goal_rot=True),
                                fixed_order=False)),
        _stack_draws, 4, True, 1.0),
    "stack-fixed-order": ("main", {}, lambda w, a: (
        j_goals.ObjectStackGoal(w.jidx, a, fixed_order=True),
        t_goals.ObjectStackGoal(w.tidx, fixed_order=True)), _stack_draws, 3, False, 1.0),
    "pickandplace": ("main", dict(randomize_goal_rot=True, rot_randomize_type="full"),
                     lambda w, a: (j_goals.PickAndPlaceGoal(w.jidx, a), t_goals.PickAndPlaceGoal(
                         w.tidx, t_goals.GoalArgs(randomize_goal_rot=True,
                                                  rot_randomize_type="full"))),
                     _pickandplace_draws, 5, False, 1.0),
    "wordblocks": ("word", {}, _word_pair, lambda *a: {}, 6, False, 1.0),
    "dominos": ("main", dict(rot_dist_type="mod180"), lambda w, a: (
        j_goals.DominoStateGoal(w.jidx, a),
        t_goals.DominoStateGoal(w.tidx, t_goals.GoalArgs(rot_dist_type="mod180"))),
        _domino_draws, 5, False, rearrange_blocks_like.DOMINO_PROPORTIONS),
    "attached": ("main", {}, lambda w, a: (j_attached.AttachedBlockStateGoal(w.jidx, a),
                                           t_attached.AttachedBlockStateGoal(w.tidx)),
                 _attached_draws, 8, False, 1.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_goal_class_matches_jax(name, main_world, word_world):
    """`next_goal` on the JAX keys' draws, then `goal_distance` and
    `relative_goal` of that goal with duplicate-object groups, against the
    JAX class under vmap; the train cases take every branch (pick-up,
    stacking, neither) in some env, the first with each env's own block
    sizes (exp-uniform in +-0.2 per axis, as blocks_train's cuboids)."""
    world_name, kw, pair, draws_fn, n, per_env, scale = CASES[name]
    w = main_world if world_name == "main" else word_world
    jargs = j_goals.GoalArgs(**kw)
    jgen, tgen = pair(w, jargs)
    keys = jax.random.split(jax.random.PRNGKey(sum(map(ord, name))), B)
    rng = np.random.default_rng(len(name))
    sizes = np.asarray(j_sim.geom_bbox_half(w.jm, w.jidx.object_geom_ids)) * scale
    sizes = sizes.astype(np.float32)
    if per_env:
        sizes = (sizes * np.exp(rng.uniform(-0.2, 0.2, (B, w.O, 3)))).astype(np.float32)
    active = np.arange(w.O) < n
    want = jax.vmap(lambda k, d, s: jgen.next_goal(k, jnp.asarray(active), s, n, d),
                    in_axes=(0, 0, 0 if per_env else None))(keys, w.jd, jnp.asarray(sizes))
    draws = batch_draws(draws_fn, keys, n, w.O, jargs)
    got = tgen.next_goal(draws, torch.as_tensor(active), torch.as_tensor(sizes), n, w.td)
    assert sorted(got) == sorted(want)
    for k in want:
        if np.asarray(want[k]).dtype.kind == "f":
            _close(got[k], want[k], 1e-6, msg=k)
        else:
            np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    if name.startswith("train"):
        p = _np(draws["p_u"])
        lo, hi = kw["pickup_proba"], kw["pickup_proba"] + kw["stacking_proba"]
        assert (p < lo).any() and ((p >= lo) & (p < hi)).any() and (p >= hi).any()
    goal = dict(want, group_ids=jnp.asarray(rng.integers(0, 3, (B, w.O))))
    tgoal = {k: torch.as_tensor(np.array(v)) for k, v in goal.items()}
    for fn in ("goal_distance", "relative_goal"):
        jout = jax.vmap(lambda g, d: getattr(jgen, fn)(g, d, jnp.asarray(active)))(goal, w.jd)
        tout = getattr(tgen, fn)(tgoal, w.td, torch.as_tensor(active))
        assert sorted(tout) == sorted(jout)
        for k in jout:
            _close(tout[k], jout[k], 1e-5, msg=f"{fn} {k}")


# ---------------------------------------------------------------------------
# placement masks and masked observations
# ---------------------------------------------------------------------------

def _near_boundary(w, rng, margin):
    """(B, O, 3) positions within 2 margins of the placement area's faces."""
    lo, hi = w.jidx.placement_bounds(5)
    pos = rng.uniform(lo, hi, (B, w.O, 3))
    face = rng.integers(0, 3, (B, w.O))
    side = rng.integers(0, 2, (B, w.O))
    edge = np.where(side == 1, hi[face], lo[face])
    out = edge + np.where(side == 1, 1.0, -1.0) * rng.uniform(-margin, 2 * margin, (B, w.O))
    np.put_along_axis(pos, face[..., None], out[..., None], axis=-1)
    return pos.astype(np.float32)


def test_placement_masks_match_jax(main_world):
    """in_placement_area, hard and soft, at margins 0.02 and 0.1, on
    positions in and around the margin band, 5 of 8 objects active: the
    soft mask on each env's one draw from the JAX key; both exactly. The
    soft mask differs from the hard one somewhere."""
    w = main_world
    rng = np.random.default_rng(3)
    active = np.arange(w.O) < 5
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    u = torch.as_tensor(np.stack([_u(k) for k in keys]))
    differs = False
    for margin in (0.02, 0.1):
        pos = _near_boundary(w, rng, margin)
        for soft in (False, True):
            want = jax.vmap(lambda p, k: j_sim.in_placement_area(
                w.jidx, p, 5, 1.0, margin, soft=soft, key=k, active_mask=jnp.asarray(active)))(
                    pos, keys)
            got = t_sim.in_placement_area(w.tidx, torch.as_tensor(pos), 5, 1.0, margin,
                                          torch.as_tensor(active), soft=soft, u=u)
            np.testing.assert_array_equal(_np(got), np.asarray(want), err_msg=f"{margin} {soft}")
        hard = _np(t_sim.in_placement_area(w.tidx, torch.as_tensor(pos), 5, 1.0, margin))
        differs |= bool((hard != _np(got)).any())
    assert differs


@pytest.mark.parametrize("soft", [False, True])
def test_masked_obs_matches_jax(main_world, soft):
    """`_masked_obs` (blocks.py:773-800) of both packages on seeded
    observations and positions around the placement area, the goal's mask
    from a seeded draw, the soft mask's draw from the JAX state key folded
    with 13: the placement masks and every masked_* observation exactly."""
    w = main_world
    rng = np.random.default_rng(4)
    active = np.arange(w.O) < 5
    args = dict(mask_margin=0.05, soft_mask=soft)
    jstub = types.SimpleNamespace(goal_gen=types.SimpleNamespace(args=j_goals.GoalArgs(**args)),
                                  parameters=j_blocks.RearrangeEnvParameters(), idx=w.jidx,
                                  num_objects=5, dtype=jnp.float32)
    tstub = types.SimpleNamespace(goal_gen=types.SimpleNamespace(args=t_goals.GoalArgs(**args)),
                                  parameters=t_blocks.RearrangeEnvParameters(), idx=w.tidx,
                                  num_objects=5, dtype=torch.float32,
                                  _active=torch.as_tensor(active))
    tstub._in_placement_area = lambda p, u: t_blocks.BlocksRearrangeEnv._in_placement_area(
        tstub, p, u)
    widths = {"obj_pos": 3, "obj_rot": 3, "obj_rel_pos": 3, "obj_vel_pos": 3, "obj_vel_rot": 3,
              "obj_gripper_contact": 2, "obj_bbox_size": 3, "obj_colors": 4, "goal_obj_pos": 3,
              "goal_obj_rot": 3, "rel_goal_obj_pos": 3, "rel_goal_obj_rot": 3}
    obs = {k: rng.standard_normal((B, w.O, n)).astype(np.float32) for k, n in widths.items()}
    pos = _near_boundary(w, rng, 0.05)
    goal_inside = rng.integers(0, 2, (B, w.O)).astype(bool)
    keys = jax.random.split(jax.random.PRNGKey(9), B)

    def jax_masked(key, gin, o, p):
        state = types.SimpleNamespace(key=key, goal={"goal_objects_in_placement_area": gin})
        return j_blocks.BlocksRearrangeEnv._masked_obs(jstub, state, o, p, jnp.asarray(active))

    want = jax.vmap(jax_masked)(keys, goal_inside, obs, pos)
    u = torch.as_tensor(np.stack([_u(jax.random.fold_in(k, 13)) for k in keys])) if soft else None
    tstate = types.SimpleNamespace(goal={"goal_objects_in_placement_area":
                                         torch.as_tensor(goal_inside)})
    got = t_blocks.BlocksRearrangeEnv._masked_obs(
        tstub, tstate, {k: torch.as_tensor(v) for k, v in obs.items()}, torch.as_tensor(pos), u)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert 0 < _np(got["placement_mask"]).mean() < 1
