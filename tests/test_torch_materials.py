"""The port's materials (`robogym_torch/envs/rearrange/materials.py`) and the
blocks env's material branch against the JAX package's, on the CPU.

Both packages read the stand-in material jsonnets committed in
`robogym_torch/worlds/materials/` (some set friction, solref, margin and
density, one sets none): the JAX module reads its `MATERIAL_DIR` when it is
imported, so the test points it there and clears `load_material_args`'
cache, in this process only. The blocks env's `_reset_model_fields` runs
in both packages on env objects that carry only what the method reads (the
UR16e-shaped world `rearrange_blocks_like.npz` through the bridge, 8 slots,
5 objects), the JAX one under `jax.vmap` on B=4 keys, the port's on the
draws those keys give (each group's material `jax.random.randint`, the
group scan's rate, Gumbel noise and colours). Tolerances: the table's rows
exactly (both parse the same strings to float64); the model fields 1e-6
relative (float32 products of the same values)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import snapshot_jax_model, snapshot_model
from robogym_torch.envs.rearrange import blocks as t_blocks
from robogym_torch.envs.rearrange import materials as t_mat
from robogym_torch.envs.rearrange import simulation as t_sim
from robogym_torch.worlds import rearrange_blocks_like
from robogym_tpu.envs.rearrange import blocks as j_blocks
from robogym_tpu.envs.rearrange import materials as j_mat
from robogym_tpu.envs.rearrange import simulation as j_sim

B = 4


@pytest.fixture(autouse=True)
def jax_materials(monkeypatch):
    """The JAX module pointed at the port's stand-in materials."""
    monkeypatch.setattr(j_mat, "MATERIAL_DIR", t_mat.MATERIAL_DIR)
    j_mat.load_material_args.cache_clear()
    yield
    j_mat.load_material_args.cache_clear()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def test_material_table_rows_equal_the_jax_table():
    names = t_mat.load_all_materials()
    assert names == j_mat.load_all_materials()
    assert set(names) == {"aluminium", "plain", "rubber", "wood"}
    for sub in (tuple(names), ("plain",), ("wood", "rubber")):
        got, want = t_mat.MaterialTable(sub), j_mat.MaterialTable(sub)
        for field in ("friction", "solref", "margin", "density_ratio"):
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), field)
    tbl = t_mat.MaterialTable(names)
    # what each stand-in sets and leaves: rubber all four, plain none
    i = {n: k for k, n in enumerate(names)}
    assert tbl.solref[i["wood"]].tolist() == [0.0, 0.0] and tbl.margin[i["wood"]] == 0.0
    assert tbl.friction[i["plain"]].tolist() == [1.0, 0.005, 0.0001]
    assert tbl.density_ratio[i["rubber"]] == 1.1 and tbl.margin[i["rubber"]] == 0.001


def _draws(keys, O, M):
    """The port's draws from the JAX env's model keys: the group scan's
    (`_sample_object_groups` on k_grp) and each group's material (k_mat)."""
    out = {k: [] for k in ("lam_u", "gumbel", "color_u", "mat_group")}
    for key in keys:
        k_grp, k_mat, _ = jax.random.split(key, 3)
        k_lam, k_cat, k_col = jax.random.split(k_grp, 3)
        out["lam_u"].append(np.float32(jax.random.uniform(k_lam, (), jnp.float32)))
        out["gumbel"].append(np.stack([np.asarray(jax.random.gumbel(k, (O,), jnp.float32))
                                       for k in jax.random.split(k_cat, O)]))
        out["color_u"].append(np.asarray(jax.random.uniform(k_col, (O, 3), jnp.float32)))
        out["mat_group"].append(np.asarray(jax.random.randint(k_mat, (O,), 0, M)))
    return {k: torch.as_tensor(np.stack(v)) for k, v in out.items()}


@pytest.mark.parametrize("names", [("all",), ("rubber", "plain")])
def test_blocks_material_fields_from_the_jax_draws(names):
    path = rearrange_blocks_like.SNAPSHOT
    jm, tm = snapshot_jax_model(path), snapshot_model(path)
    O = 8
    jpar = j_blocks.RearrangeEnvParameters(
        simulation_params=j_blocks.RearrangeSimParameters(num_objects=5, max_num_objects=O),
        material_names=names)
    tpar = t_blocks.RearrangeEnvParameters(
        simulation_params=t_blocks.RearrangeSimParameters(num_objects=5, max_num_objects=O),
        material_names=names)
    full = tuple(t_mat.load_all_materials()) if names == ("all",) else names
    jenv = object.__new__(j_blocks.BlocksRearrangeEnv)
    jenv.__dict__.update(model=jm, idx=j_sim.RearrangeIndex.build(jm, O), parameters=jpar,
                         dtype=jnp.float32, _material_table=j_mat.MaterialTable(full))
    tenv = object.__new__(t_blocks.BlocksRearrangeEnv)
    tenv.__dict__.update(model=tm, idx=t_sim.RearrangeIndex.build(tm, O), parameters=tpar,
                         _material_table=t_mat.MaterialTable(full))
    keys = jax.random.split(jax.random.PRNGKey(7), B)
    want, _, want_gid = jax.vmap(jenv._reset_model_fields)(keys)
    draws = _draws(keys, O, len(full))
    got, _, gid = tenv._reset_model_fields(draws, B)
    np.testing.assert_array_equal(_np(gid), np.asarray(want_gid))
    assert set(got) == set(want) == {"geom_rgba", "geom_friction", "geom_solref", "geom_margin",
                                      "body_mass", "body_inertia"}
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=1e-6, atol=0, err_msg=k)
    # the objects' rows vary with the drawn materials, the rest stay compiled
    gids = np.asarray(tenv.idx.object_geom_ids)
    fr = _np(got["geom_friction"])
    assert len(np.unique(fr[:, gids, 0])) > 1
    others = np.setdiff1d(np.arange(fr.shape[1]), gids)
    np.testing.assert_array_equal(fr[:, others], np.broadcast_to(_np(tm.geom_friction)[others],
                                                                  fr[:, others].shape))


def test_material_draw_is_one_index_a_group():
    tbl = t_mat.MaterialTable(t_mat.load_all_materials())
    gen = torch.Generator().manual_seed(0)
    idx = tbl.draw(gen, 64, 8)
    assert idx.shape == (64, 8) and idx.dtype == torch.long
    assert int(idx.min()) >= 0 and int(idx.max()) < len(tbl.names)
    assert len(torch.unique(idx)) == len(tbl.names)
