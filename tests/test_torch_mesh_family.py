"""The rest of the port's mesh rearrange envs (table setting, chessboard,
the mixture and the composer) and the mixture's datasets against the JAX
package's, on the CPU, at a small size: `mujoco_substeps=2`,
`stabilize_steps=1`, B=3, the default control (TCP through the mocap_ik
dual sim); 5 slots for the table setting (the spoon's turned goal), 3 for
the chessboard and the mixture, 2 for the composer (3 sub-geoms each, the
candidates `bowl` and `can`).

Each JAX env is built, once per env (a module-scoped fixture), by its own
`make_env` on the stand-ins: in this process only,
`simulation.build_blocks_world_xml` points at `rearrange_blocks_like.write`
with the YCB stand-in's table top, and `mesh.ASSETS_DIR` and
`xml_tools.ASSETS_DIR` at a directory whose `stls/ycb` holds copies of the
YCB stand-ins (the tableware's for the table setting, whose world also
takes `rearrange_mesh_family_like.table_setting_contact_xml`), `stls/chess`
and `stls/geom` of `rearrange_mesh_family_like`'s
(`tools/build_locked_like_snapshot.ycb_stand_in`, `family_stand_in`). The port's env is built
by its own `make_env` on the JAX env's compiled models and starts from the
JAX env's settled initial state. Draws come from the JAX keys: the
mixture's dataset and candidates are the JAX package's categorical draws,
the composer's candidates, sub-geom counts and offsets its `randint` and
`uniform` draws.

Tolerances as `test_torch_mesh.py` holds the YCB env: the bank's hulls and
masks exactly, its masses, inertias and frames 1e-6 relative; the
per-episode model fields exactly (the composer's composed inertia 1e-6
relative: `assert_fields_equal`); the contact table of the reset state
with each env's own fields (hulls; the composer's sub-geom offsets) as
`test_torch_collision.py` holds it; physics by the nudge rule over the
whole batch."""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_collision import _compare_tables
from test_torch_mesh import (REPO, _jax_data, _np, _t, compare_state, compare_step, from_jax_start,
                             port_reset, port_step, port_worlds, snapshot_tool)
from test_torch_rearrange import _to_port
from test_torch_rearrange_family import _goal_draws, _mask_draws, _stack, jax_step_draws
from robogym_torch import bridge
from robogym_torch.envs import core as t_core
from robogym_torch.envs.rearrange import chessboard as t_chess
from robogym_torch.envs.rearrange import composer as t_composer
from robogym_torch.envs.rearrange import mesh as t_mesh
from robogym_torch.envs.rearrange import mixture as t_mixture
from robogym_torch.envs.rearrange import table_setting as t_table
from robogym_torch.envs.rearrange.datasets.objects import local_mesh as t_local_mesh
from robogym_torch.mjcf.model import GeomType
from robogym_torch.physics import step as t_step
from robogym_torch.physics.collision import driver as t_driver
from robogym_torch.utils import env_utils as t_env_utils
from robogym_torch.worlds import rearrange_mesh_family_like as family
from robogym_torch.worlds import rearrange_ycb_like
from robogym_tpu.envs import core as j_core
from robogym_tpu.envs.rearrange import chessboard as j_chess
from robogym_tpu.envs.rearrange import composer as j_composer
from robogym_tpu.envs.rearrange import mixture as j_mixture
from robogym_tpu.envs.rearrange import table_setting as j_table
from robogym_tpu.physics import step as j_step
from robogym_tpu.utils import env_utils as j_env_utils

B = 3
CONSTANTS = {"mujoco_substeps": 2, "stabilize_steps": 1}
COMPOSER_MESHES = ["bowl", "can"]


def _params(n):
    return {"simulation_params": {"num_objects": n, "max_num_objects": n}}


ENVS = {
    "table_setting": dict(jax=lambda: j_table.make_env(CONSTANTS, _params(5)),
                          port=lambda w: t_table.make_env(CONSTANTS, _params(5), device="cpu",
                                                          worlds=w)),
    "chessboard": dict(jax=lambda: j_chess.make_env(CONSTANTS, _params(3)),
                       port=lambda w: t_chess.make_env(CONSTANTS, _params(3), device="cpu",
                                                       worlds=w)),
    "mixture": dict(jax=lambda: j_mixture.make_env(CONSTANTS, _params(3)),
                    port=lambda w: t_mixture.make_env(CONSTANTS, _params(3), device="cpu",
                                                      worlds=w)),
    "composer": dict(jax=lambda: j_composer.make_env(CONSTANTS, _params(2),
                                                     mesh_names=COMPOSER_MESHES),
                     port=lambda w: t_composer.make_env(CONSTANTS, _params(2),
                                                        mesh_names=COMPOSER_MESHES,
                                                        device="cpu", worlds=w)),
}


# ---------------------------------------------------------------------------
# the envs: one JAX construction each, the port's on its models
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """built(name): (JAX env, port env, the JAX env's jitted batched reset
    and step) of one env, each built once."""
    cache = {}

    def get(name):
        if name not in cache:
            root = str(tmp_path_factory.mktemp(name))
            tool = snapshot_tool()
            with tool.ycb_stand_in(root, *tool.family_stand_in(name)):
                jenv = ENVS[name]["jax"]()
            tenv = from_jax_start(ENVS[name]["port"](port_worlds(jenv)), jenv)
            cache[name] = (jenv, tenv, jax.jit(jax.vmap(jenv.reset)),
                           jax.jit(jax.vmap(jenv.step)))
        return cache[name]

    return get


def _group_draws(jenv, k_grp):
    """`_sample_object_groups`' draws from its key (blocks.py:348-382)."""
    k_lam, k_cat, k_col = jax.random.split(k_grp, 3)
    n = jenv.max_num_objects
    return dict(lam_u=jax.random.uniform(k_lam, (), jnp.float32),
                gumbel=np.stack([np.asarray(jax.random.gumbel(k, (n,), jnp.float32))
                                 for k in jax.random.split(k_cat, n)]),
                color_u=np.asarray(jax.random.uniform(k_col, (n, 3), jnp.float32)))


def model_draws(name, jenv, k_model):
    """Each env's `_reset_model_fields` draws from its key: none for the
    table setting; the candidates (with replacement) and the groups for
    the chessboard (mesh.py:232-245); the dataset, the candidates and the
    groups for the mixture (mixture.py:102-109); the candidates, sub-geom
    counts, offsets and groups for the composer (composer.py:144-158)."""
    n = jenv.max_num_objects
    if name == "table_setting":
        return {}
    if name == "chessboard":
        k_cand, k_grp = jax.random.split(k_model)
        return dict(cand=np.asarray(jax.random.choice(k_cand, jenv.bank.num_candidates, (n,))),
                    **_group_draws(jenv, k_grp))
    if name == "mixture":
        k_ds, k_cand, k_grp = jax.random.split(k_model, 3)
        ds = jax.random.categorical(k_ds, jenv._dataset_logits)
        cand = jax.random.categorical(k_cand, jenv._cand_logits[ds][None, :].repeat(n, 0),
                                      axis=-1)
        return dict(ds=np.asarray(ds), cand=np.asarray(cand), **_group_draws(jenv, k_grp))
    K = jenv.constants.max_geoms_per_object
    k_cand, k_num, k_off, k_grp = jax.random.split(k_model, 4)
    return dict(cand=np.asarray(jax.random.randint(k_cand, (n, K), 0, jenv._tiny_idx)),
                num_geoms=np.asarray(jax.random.randint(k_num, (n,), 1, K + 1)),
                off_u=np.asarray(jax.random.uniform(k_off, (n, K, 3), jnp.float32)),
                **_group_draws(jenv, k_grp))


def reset_draws(name, jenv, keys):
    """The port's `reset` draws from the JAX reset keys (blocks.py:384-438)."""
    n, per = jenv.max_num_objects, []
    for key in keys:
        k_place, k_rot, _, k_goal, k_pause, k_state, k_model = jax.random.split(key, 7)
        per.append(dict(
            place_u=np.stack([np.asarray(jax.random.uniform(k, (20, 2), jnp.float32))
                              for k in jax.random.split(k_place, n)]),
            place_rot_u=np.asarray([jax.random.uniform(k, ()) for k in jax.random.split(k_rot, n)]),
            goal=_goal_draws(jenv, k_goal), pause_u=jax.random.uniform(k_pause, ()),
            **_mask_draws(jenv, k_goal, k_state), **model_draws(name, jenv, k_model)))
    return _stack(per)


# ---------------------------------------------------------------------------
# stand-ins, datasets, banks and model fields
# ---------------------------------------------------------------------------

def test_stand_in_files_match_their_writer(tmp_path):
    """The committed stand-in STLs are what `write_candidates` writes, and
    every candidate has 64 hull verts."""
    written = family.write_candidates(str(tmp_path))
    assert len(written) == 12
    for key, path in written.items():
        with open(path) as a, open(os.path.join(family.MESH_ROOT, key,
                                                os.path.basename(path))) as b:
            assert a.read() == b.read(), key
    for d in (family.TABLEWARE_DIR, family.CHESS_DIR, family.GEOM_DIR):
        bank = t_mesh.MeshObjectBank.build(t_mesh.find_meshes_by_dirname(d))
        assert (_np(bank.hull_mask).sum(-1) == 64).all(), d


@pytest.mark.parametrize("env", sorted(family.SNAPSHOTS))
def test_world_snapshot_matches_fresh_compile(env):
    """Each committed world equals the JAX env's `_compile_world` now: the
    slots each owning their meshes, nv = 12 + 6 x slots, no box-box pair;
    the composer's 3 sub-geoms a slot and its budgets of
    `scale_contact_budgets(model, 8, 16)` (ncon_active 136, group_cap 128)."""
    world = "rearrange_%s_like" % env
    tool = snapshot_tool()
    _, fresh = tool.compile_snapshot(world)
    with np.load(tool.snapshot_path(world)) as z:
        assert sorted(fresh) == sorted(z.files)
        for k in z.files:
            assert np.array_equal(fresh[k], z[k]), k
    m = t_mesh.blocks_lib._load(family.SNAPSHOTS[env], "cpu")
    O = family.SLOTS[env]
    c = m.const
    assert c.nv == 12 + 6 * O
    K = family.COMPOSER_SUB_GEOMS if env == "composer" else 1
    gids = [c.names["geom"][f"object{i}" + (f":g{k}" if k else "")]
            for i in range(O) for k in range(K)]
    assert len({int(c.geom_dataid[g]) for g in gids}) == O * K
    kinds = {(g["t1"], g["t2"]) for g in t_driver.build_groups(c, m.opt.group_cap)}
    assert (GeomType.BOX, GeomType.BOX) not in kinds
    if env == "composer":
        assert (m.opt.ncon_active, m.opt.group_cap) == (136, 128)


def check_default_mixture_configs():
    """`get_function` resolves the mixture's default `robogym.` configs to
    the port's datasets, as the JAX package's resolves them to its own;
    the object datasets hold the stand-ins, and `mesh_names` keeps a
    dataset to the names it lists."""
    for cfg in list(t_mixture.DEFAULT_OBJECT_CONFIG.values()) + list(
            t_mixture.DEFAULT_DATASET_CONFIG.values()):
        fn = t_env_utils.get_function(cfg)
        jfn = j_env_utils.get_function(cfg)
        assert fn.func.__module__.replace("robogym_torch", "robogym_tpu") == jfn.func.__module__
        assert fn.keywords == jfn.keywords
    objects, envstates, merged = t_mixture.datasets()
    assert objects["ycb"].object_names == sorted(os.listdir(rearrange_ycb_like.MESH_DIR))
    assert objects["geom"].object_names == ["box", "cylinder", "frustum", "spindle"]
    assert sorted(envstates) == ["geom_dataset", "mixed_dataset", "ycb_dataset"]
    assert len(merged) == 10 and all(k.split("/")[0] in ("ycb", "geom") for k in merged)
    kept = t_local_mesh.create("ycb", mesh_names=["can", "bowl"])
    assert kept.object_names == ["bowl", "can"]


def check_candidate_weights(built):
    """The mixture's envstate datasets: their weights over the merged bank
    and the dataset probabilities give the JAX env's logits; a candidate
    outside an envstate dataset's object datasets has weight 0, and the
    port's own draws never pick one (4096 envs: every dataset drawn)."""
    jenv, tenv, _, _ = built("mixture")
    w = tenv.candidate_weights
    assert tenv.dataset_names == ["geom_dataset", "mixed_dataset", "ycb_dataset"]
    assert np.array_equal(np.log(np.maximum(w, 1e-12)).astype(np.float32),
                          np.asarray(jenv._cand_logits))
    assert np.array_equal(np.log(np.maximum(tenv.dataset_probs, 1e-12)).astype(np.float32),
                          np.asarray(jenv._dataset_logits))
    geom = np.asarray([n.startswith("geom/") for n in tenv.bank.names])
    assert (w[0, ~geom] == 0).all() and (w[2, geom] == 0).all() and (w[1] > 0).all()
    np.testing.assert_allclose(w.sum(-1), 1.0, rtol=1e-12)
    draws = tenv.draw_reset(4096)
    ds, cand = _np(draws["ds"]), _np(draws["cand"])
    assert sorted(np.unique(ds)) == [0, 1, 2]
    assert (w[ds[:, None], cand] > 0).all()
    want = jax.random.categorical(jax.random.PRNGKey(0), jenv._cand_logits[0][None, :], axis=-1,
                                  shape=(4096, 1))
    assert (w[0, np.asarray(want)] > 0).all()


def assert_fields_equal(got, want, name):
    """Per-episode model fields exactly, but the composer's composed
    inertia to 1e-6 relative: XLA fuses its parallel-axis terms and their
    sum over the sub-geoms, and rounds them otherwise than any order of
    float32 operations does (some entries a few ulps apart)."""
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if name == "composer" and k == "body_inertia":
            np.testing.assert_allclose(_np(got[k]), np.asarray(v), rtol=1e-6, atol=0)
        else:
            assert np.array_equal(_np(got[k]), np.asarray(v)), k


def check_bank(built, name):
    """The bank against the JAX env's (the composer's placeholder row
    included): names, hulls and masks exactly, mass, inertia, frame and
    bbox 1e-6 relative."""
    jenv, tenv, _, _ = built(name)
    jb, tb = jenv.bank, tenv.bank
    assert tb.names == jb.names
    assert np.array_equal(_np(tb.hull_vert), np.asarray(jb.hull_vert))
    assert np.array_equal(_np(tb.hull_mask), np.asarray(jb.hull_mask))
    for k in ("mass", "inertia", "iquat", "bbox_half"):
        np.testing.assert_allclose(_np(getattr(tb, k)), np.asarray(getattr(jb, k)), rtol=1e-6,
                                   atol=0, err_msg=k)


def check_reset_model_fields(built, name):
    """`_reset_model_fields` on the JAX keys' draws gives the JAX fields,
    the objects' half-sizes and group ids exactly. The composer's
    `geom_pos` differs across envs on exactly its active sub-geoms past
    the root."""
    jenv, tenv, _, _ = built(name)
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    want_f, want_s, want_g = jax.jit(jax.vmap(jenv._reset_model_fields))(keys)
    draws = _stack([model_draws(name, jenv, k) for k in keys])
    if name == "table_setting":
        draws = {}
    got_f, got_s, got_g = tenv._reset_model_fields(draws, 8)
    assert_fields_equal(got_f, want_f, name)
    assert np.array_equal(_np(got_s), np.broadcast_to(np.asarray(want_s), _np(got_s).shape))
    assert np.array_equal(_np(got_g), np.broadcast_to(np.asarray(want_g), _np(got_g).shape))
    if name == "composer":
        pos = _np(got_f["geom_pos"])
        moved = (pos != pos[:1]).any(-1).any(0)
        sub = tenv._sub_geom_ids
        assert moved[sub[:, 1:]].all() and not moved[sub[:, 0]].any()
        assert moved.sum() == sub[:, 1:].size




# ---------------------------------------------------------------------------
# the first state's contacts, reset and two steps
# ---------------------------------------------------------------------------

def _posed(jenv, jstate):
    """The reset state with object 1 pressed onto object 0: straight above
    it, their centres apart by half the sum of their half-heights
    (`geom_size`), so that their hulls (each env's own; the composer's
    sub-geoms at each env's own offsets) meet."""
    arrays = {k: np.array(v) for k, v in bridge.data_to_numpy(jstate.physics).items()}
    adr = jenv.idx.object_qpos_adr
    h = np.asarray(jstate.model_fields["geom_size"])[:, jenv.idx.object_geom_ids[:2], 2]
    arrays["qpos"][:, adr[1]:adr[1] + 3] = arrays["qpos"][:, adr[0]:adr[0] + 3]
    arrays["qpos"][:, adr[1] + 2] += 0.5 * h.sum(-1)
    return arrays


def check_first_state_contacts(built, name):
    """The contact table of the reset state with two objects pressed
    together, each env with its own fields, against the JAX package's
    `fwd_position` under `jax.vmap`; the pressed objects' hulls meet in
    every env (for the composer, sub-geoms past a root among them)."""
    jenv, tenv, reset, _ = built(name)
    jstate, _ = reset(jax.random.split(jax.random.PRNGKey(4), B))
    fields = {k: _t(v) for k, v in jstate.model_fields.items()}
    tm = t_core.apply_model_fields(tenv.model, fields)
    arrays = _posed(jenv, jstate)
    jd = jax.jit(jax.vmap(lambda f, d: j_step.fwd_position(
        j_core.apply_model_fields(jenv.model, f), d)))(
            jstate.model_fields, jax.tree_util.tree_map(jnp.asarray, _jax_data(arrays)))
    td = t_step.fwd_position(tm, bridge.data_from_numpy(arrays, "cpu"))
    _compare_tables(tm, jd, td)
    bodies = list(tenv.idx.object_body_ids[:2])
    live = _np(td.contact.active)
    b1, b2 = _np(td.contact.body1), _np(td.contact.body2)
    meet = live & np.isin(b1, bodies) & np.isin(b2, bodies) & (b1 != b2)
    assert meet.any(axis=1).all(), "the pressed objects' hulls meet in every env"
    if name == "composer":
        geoms = set(_np(td.contact.geom1)[meet]) | set(_np(td.contact.geom2)[meet])
        assert geoms - set(tenv.idx.object_geom_ids), "no sub-geom past a root is live"


def _f64(x):
    return x.double() if isinstance(x, torch.Tensor) and torch.is_floating_point(x) else x


def float64_reset(env, draws):
    """The port's reset in float64 on the same draws: a run perturbed by
    rounding alone (a flat face on the table meets float32 ties that a
    velocity nudge does not move)."""
    saved = {k: getattr(env, k) for k in ("model", "solver_model", "_initial_data",
                                          "_initial_solver_data", "bank")}
    env.model = bridge.model_to(saved["model"], "cpu", torch.float64)
    if saved["solver_model"] is not None:
        env.solver_model = bridge.model_to(saved["solver_model"], "cpu", torch.float64)
        env._initial_solver_data = t_core.data_map(_f64, saved["_initial_solver_data"])
    env._initial_data = t_core.data_map(_f64, saved["_initial_data"])
    env.bank = dataclasses.replace(saved["bank"], **{
        f.name: _f64(getattr(saved["bank"], f.name)) for f in dataclasses.fields(saved["bank"])
        if f.name != "names"})
    try:
        return env.reset(B, {k: _f64(v) for k, v in draws.items()})[0]
    finally:
        for k, v in saved.items():
            setattr(env, k, v)


@pytest.fixture(scope="module")
def runs(built):
    """runs(name): the JAX reset of seed 5 and the port's on its draws, then
    two steps, each from the JAX state carried across, actions uniform in
    [-1, 1]: [(port's output, its nudged runs and its float64 run), JAX's
    output]."""
    cache = {}

    def get(name):
        if name not in cache:
            jenv, tenv, reset, step = built(name)
            keys = jax.random.split(jax.random.PRNGKey(5), 3)
            jstate, jobs = reset(keys)
            draws = reset_draws(name, jenv, keys)
            (tout, nudged) = port_reset(tenv, draws)
            out = [((tout, nudged + [float64_reset(tenv, draws)]), (jstate, jobs))]
            rng = np.random.default_rng(5)
            for _ in range(2):
                action = rng.uniform(-1, 1, (3, tenv.action_size)).astype(np.float32)
                tout = port_step(tenv, _to_port(jstate), _t(action),
                                 jax_step_draws(jenv, jstate))
                jout = step(jstate, jnp.asarray(action))
                out.append((tout, jout))
                jstate = jout[0]
            cache[name] = out
        return cache[name]

    return get


def check_reset(built, runs, name):
    """The reset: each env's fields exactly, the objects placed and settled
    under them by the nudge rule, the goals as the JAX package's (the
    fixed goals' placements exactly)."""
    _, tenv, _, _ = built(name)
    ((tstate, tobs), nudged), (jstate, jobs) = runs(name)[0]
    compare_state(tstate, tobs, jstate, jobs, tenv, nudged, settled=False)
    assert_fields_equal(tstate.model_fields, jstate.model_fields, name)
    if name in ("table_setting", "chessboard"):
        for k in ("obj_pos", "obj_rot"):
            assert np.array_equal(_np(tstate.goal[k]), np.asarray(jstate.goal[k])), k
    if name == "table_setting":
        assert abs(float(_np(tstate.goal["obj_rot"])[0, 4, 3]) - np.sin(0.19)) < 1e-7


def check_step(built, runs, name, i):
    """Each of the two steps from the JAX state, by the nudge rule."""
    _, tenv, _, _ = built(name)
    (tout, nudged), jout = runs(name)[i]
    compare_step(tout, jout, tenv, nudged, settled=False)


# ---------------------------------------------------------------------------
# this file's envs (the mixture and the composer: test_torch_mesh_mixture.py)
# ---------------------------------------------------------------------------

FIXED = ["chessboard", "table_setting"]


@pytest.mark.parametrize("name", FIXED)
def test_bank_matches_jax(built, name):
    check_bank(built, name)


@pytest.mark.parametrize("name", FIXED)
def test_reset_model_fields_match_jax(built, name):
    check_reset_model_fields(built, name)


@pytest.mark.parametrize("name", FIXED)
def test_first_state_contacts_match_jax(built, name):
    check_first_state_contacts(built, name)


@pytest.mark.parametrize("name", FIXED)
def test_reset_matches_jax(built, runs, name):
    check_reset(built, runs, name)


@pytest.mark.parametrize("i", [1, 2])
@pytest.mark.parametrize("name", FIXED)
def test_steps_match_jax(built, runs, name, i):
    check_step(built, runs, name, i)


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import robogym_torch.envs.rearrange.table_setting, robogym_torch.envs.rearrange.chessboard\n"
        "import robogym_torch.envs.rearrange.mixture, robogym_torch.envs.rearrange.composer\n"
        "import robogym_torch.envs.rearrange.datasets.objects.local_mesh\n"
        "import robogym_torch.envs.rearrange.datasets.envstates.random\n"
        "import robogym_torch.worlds.rearrange_mesh_family_like\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'robogym_tpu'))]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
