"""The port's "block" goal rotation and icp rotational distance
(`robogym_torch/envs/rearrange/goals.py`, `robogym_torch/utils/icp.py`)
against the JAX package's `goals.py` and `utils/icp.py`, on the CPU.

Block rotations: `sample_goal_rotations` on B=4 envs of 8 objects from the
draws of the JAX keys (per object, the z angle's uniform in float64, as
conftest's x64 makes `uniform_z_quat` draw it, and the cube rotation's
`randint`), exactly in float32 (the same float32 products in the same
order). ICP: the nearest neighbour, the SVD fit, the whole `icp` and the
distance on box-corner clouds (the blocks env's, half-sizes from the
UR16e-shaped world and cuboids) and on a 40-point cloud, at seeded
rotations, within 1e-5 (float32 SVDs of two libraries)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogym_torch.envs.rearrange import goals as t_goals
from robogym_torch.utils import icp as t_icp
from robogym_torch.utils import rotation as t_rot
from robogym_tpu.envs.rearrange import goals as j_goals
from robogym_tpu.utils import icp as j_icp
from robogym_tpu.utils import rotation as j_rot

B, O = 4, 8
TOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_block_rotations_from_the_jax_draws():
    args = j_goals.GoalArgs(randomize_goal_rot=True, rot_randomize_type="block")
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    want = jax.vmap(lambda k: j_goals.sample_goal_rotations(k, O, args, jnp.float32))(keys)
    u, choice = [], []
    for key in keys:
        for k in jax.random.split(key, O):
            k1, k2 = jax.random.split(k)
            u.append(float(jax.random.uniform(k1, (), jnp.float64)))
            choice.append(int(jax.random.randint(k2, (), 0, 24)))
    u = torch.tensor(u, dtype=torch.float64).reshape(B, O)
    choice = torch.tensor(choice).reshape(B, O)
    targs = t_goals.GoalArgs(randomize_goal_rot=True, rot_randomize_type="block")
    got = t_goals.sample_goal_rotations(u, B, O, targs, torch.float32, choice=choice)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    # every one a z-rotation times a cube rotation: the world's z axis lies
    # along an axis of the box
    zax = _np(t_rot.quat2mat(got.double()))[..., 2, :]
    assert np.allclose(np.sort(np.abs(zax), -1)[..., :2], 0.0, atol=1e-6)


def test_block_draw_and_goal():
    """The goal class draws a uniform and a cube-rotation index per object
    for "block", and its goal's rotations are unit quaternions."""
    from test_torch_rearrange_goals import World
    from robogym_torch.worlds import rearrange_blocks_like

    w = World(rearrange_blocks_like.SNAPSHOT, 0)
    args = t_goals.GoalArgs(randomize_goal_rot=True, rot_randomize_type="block")
    goal = t_goals.ObjectStateGoal(w.tidx, args)
    gen = torch.Generator().manual_seed(1)
    draws = goal.draw(gen, 16, 5)
    assert draws["rot_u"].shape == (16, w.O) and draws["rot_choice"].shape == (16, w.O)
    assert int(draws["rot_choice"].max()) < 24
    out = goal.next_goal(draws, torch.arange(w.O) < 5, torch.full((w.O, 3), 0.0254), 5,
                         w.td)
    np.testing.assert_allclose(_np(t_rot.norm(out["obj_rot"])), 1.0, atol=1e-6)


def _corners(half):
    signs = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                     np.float32)
    return (np.asarray(half, np.float32)[:, None, :] * signs[None]).astype(np.float32)


def _quats(rng, n):
    q = rng.standard_normal((n, 4))
    return (q / np.linalg.norm(q, axis=-1, keepdims=True)).astype(np.float32)


CLOUDS = {
    "cube": lambda rng: _corners(np.full((O, 3), 0.0254)),
    "cuboid": lambda rng: _corners(0.0254 * np.exp(rng.uniform(-0.2, 0.2, (O, 3)))),
    "cloud40": lambda rng: (0.05 * rng.standard_normal((O, 40, 3))).astype(np.float32),
}


@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_icp_distance_matches_jax(cloud):
    rng = np.random.default_rng(11)
    verts = CLOUDS[cloud](rng)
    q2 = _quats(rng, B * O).reshape(B, O, 4)
    # q1 near q2 (the distance's use: an object near its goal) and far
    near = q2 + 0.05 * rng.standard_normal((B, O, 4)).astype(np.float32)
    for q1 in (near / np.linalg.norm(near, axis=-1, keepdims=True), _quats(rng, B * O)
               .reshape(B, O, 4)):
        q1 = q1.astype(np.float32)
        want = jax.vmap(lambda a, b: j_goals.rot_distance(a, b, "icp", jnp.asarray(verts)))(
            jnp.asarray(q1), jnp.asarray(q2))
        got = t_goals.rot_distance(torch.as_tensor(q1), torch.as_tensor(q2), "icp",
                                   torch.as_tensor(verts))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=TOL)
        assert got.shape == (B, O)


def test_icp_parts_match_jax():
    rng = np.random.default_rng(5)
    A = (0.05 * rng.standard_normal((O, 30, 3))).astype(np.float32)
    q = _quats(rng, O)
    Bc = np.einsum("oij,onj->oni", _np(t_rot.quat2mat(torch.as_tensor(q))), A) + 0.01
    Bc = Bc.astype(np.float32)
    dist, idx = t_icp.nearest_neighbor(torch.as_tensor(A), torch.as_tensor(Bc))
    jd, ji = jax.vmap(j_icp.nearest_neighbor)(jnp.asarray(A), jnp.asarray(Bc))
    np.testing.assert_array_equal(_np(idx), np.asarray(ji))
    np.testing.assert_allclose(_np(dist), np.asarray(jd), rtol=0, atol=TOL)
    R, t = t_icp.best_fit_transform(torch.as_tensor(A), torch.as_tensor(Bc))
    jR, jt = jax.vmap(j_icp.best_fit_transform)(jnp.asarray(A), jnp.asarray(Bc))
    np.testing.assert_allclose(_np(R), np.asarray(jR), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(t), np.asarray(jt), rtol=0, atol=TOL)
    T, err = t_icp.icp(torch.as_tensor(A), torch.as_tensor(Bc))
    jT, jerr = jax.vmap(j_icp.icp)(jnp.asarray(A), jnp.asarray(Bc))
    np.testing.assert_allclose(_np(T), np.asarray(jT), rtol=0, atol=TOL)
    np.testing.assert_allclose(_np(err), np.asarray(jerr), rtol=0, atol=TOL)


def test_mat2quat_matches_jax():
    rng = np.random.default_rng(2)
    q = _quats(rng, 256)
    q[:4] = [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]]
    mats = np.asarray(jax.vmap(j_rot.quat2mat)(jnp.asarray(q)))
    want = jax.vmap(j_rot.mat2quat)(jnp.asarray(mats))
    got = t_rot.mat2quat(torch.as_tensor(np.array(mats)))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=1e-6)


def test_icp_relative_rotation_is_the_full_difference():
    rng = np.random.default_rng(4)
    q1, q2 = (torch.as_tensor(_quats(rng, B * O).reshape(B, O, 4)) for _ in range(2))
    np.testing.assert_array_equal(_np(t_goals.relative_rot_euler(q1, q2, "icp")),
                                  _np(t_goals.relative_rot_euler(q1, q2, "full")))
