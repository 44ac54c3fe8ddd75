"""The port's mesh rearrange env (YCB, YCB pick-and-place) against the JAX
package's, on the CPU, at a small size: 2 mesh slots, 3 candidates (the
stand-ins `bowl`, `can` and `die`: 64, 64 and 12 hull verts), B=3,
`mujoco_substeps=2`, the default control (TCP through the mocap_ik dual
sim), `stabilize_goal` on.

The JAX env is built on the stand-in world by pointing, in this process
only, `simulation.build_blocks_world_xml` at `rearrange_blocks_like.write`
with the YCB stand-in's table top (`rearrange_ycb_like.table_top_xml`) and
`mesh.ASSETS_DIR` at a directory holding copies of the stand-in STLs
(`tools/build_locked_like_snapshot.ycb_stand_in`). The port's env is built
by its own `make_env` on the JAX env's compiled models (`worlds=`) and
starts from the JAX env's settled initial state. Draws come from the JAX
keys (the mesh env's model key splits into the candidates' and the
groups'), and states cross by `bridge.env_state_to_numpy` /
`env_state_from_numpy`.

Tolerances: the bank's hulls and masks exactly, its masses, inertias and
frames 1e-6 relative; the per-episode model fields exactly; the contact
table of a posed state with each env's own hulls as
`test_torch_collision.py` holds it; physics by the env-step envelope of
`_torch_common.assert_physics_close` under its nudge rule over the whole
batch (both sims' start velocities nudged by 1e-6, the goal settle's
too, and for a step also the port's run in float64 from the same state); a
settled goal's poses the same way; the obs on the envs within every
envelope as `test_torch_rearrange_family.py` holds them; rewards, done,
the tracker and the info's integers and booleans exactly."""

import contextlib
import copy
import dataclasses
import importlib.util
import os
import subprocess
import sys
import tempfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import NUDGE, QPOS_TOL, _env_err, _groups, assert_physics_close
from test_torch_collision import _compare_tables
from test_torch_rearrange import _objects, _obs_tol, _port_model, _to_port, _within_envelope
from test_torch_rearrange_family import (_goal_draws, _mask_draws, _stack, float64_step,
                                         jax_step_draws)
from robogym_torch import bridge
from robogym_torch.envs import core as t_core
from robogym_torch.envs.rearrange import blocks as t_blocks
from robogym_torch.envs.rearrange import mesh as t_mesh
from robogym_torch.envs.rearrange import ycb_pickandplace as t_ycb_pp
from robogym_torch.mjcf.model import GeomType
from robogym_torch.physics import step as t_step
from robogym_torch.physics.collision import driver as t_driver
from robogym_torch.worlds import rearrange_ycb_like
from robogym_tpu.envs import core as j_core
from robogym_tpu.envs.rearrange import blocks as j_blocks
from robogym_tpu.envs.rearrange import goals as j_goals
from robogym_tpu.envs.rearrange import mesh as j_mesh
from robogym_tpu.physics import step as j_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 3
O = 2
NAMES = ["bowl", "can", "die"]
CONSTANTS = {"mujoco_substeps": 2, "goal_args": {"stabilize_goal": True}}
PARAMETERS = {"simulation_params": {"num_objects": 2, "max_num_objects": O}}
GOAL_IDX = types.SimpleNamespace(cube_pos_qpos=(7 * np.arange(O)[:, None] + np.arange(3)).ravel())
EULER = ("obj_rot", "goal_obj_rot", "rel_goal_obj_rot")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(x):
    return torch.as_tensor(np.array(x))


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(_np(got).astype(np.float64), np.asarray(want, np.float64), rtol=0,
                               atol=tol, err_msg=msg)


def snapshot_tool():
    spec = importlib.util.spec_from_file_location(
        "build_locked_like_snapshot", os.path.join(REPO, "tools", "build_locked_like_snapshot.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def port_files():
    return {k: v for k, v in t_mesh.find_meshes_by_dirname(rearrange_ycb_like.MESH_DIR).items()
            if k in NAMES}


# ---------------------------------------------------------------------------
# the JAX env and the port's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_env(tmp_path_factory):
    with snapshot_tool().ycb_stand_in(str(tmp_path_factory.mktemp("ycb"))) as files:
        return j_mesh.YcbRearrangeEnv(
            j_mesh.MeshRearrangeEnvConstants(mujoco_substeps=2,
                                             goal_args=(("stabilize_goal", True),)),
            j_blocks.RearrangeEnvParameters(simulation_params=j_blocks.RearrangeSimParameters(
                **PARAMETERS["simulation_params"])),
            mesh_names=NAMES, mesh_files_by_name=files)


def port_worlds(jenv):
    return {"model": _port_model(jenv.model), "solver_model": _port_model(jenv.solver_model)}


def from_jax_start(env, jenv):
    env._initial_data = t_core.data_map(lambda x: x[None], bridge.data_from_numpy(
        bridge.data_to_numpy(jenv._initial_data), "cpu"))
    return env


@pytest.fixture(scope="module")
def jax_fns(jax_env):
    """The JAX env's reset and step, jitted over the batch once."""
    return jax.jit(jax.vmap(jax_env.reset)), jax.jit(jax.vmap(jax_env.step))


@pytest.fixture(scope="module")
def port_env(jax_env):
    return from_jax_start(t_mesh.make_env(CONSTANTS, PARAMETERS, mesh_names=NAMES,
                                          mesh_files_by_name=port_files(), device="cpu",
                                          worlds=port_worlds(jax_env)), jax_env)


# ---------------------------------------------------------------------------
# draws from the JAX keys, nudged runs, comparisons
# ---------------------------------------------------------------------------

def _model_draws(jenv, k_model):
    """The mesh env's `_reset_model_fields` draws from its key
    (mesh.py:232-245): the candidates, then the groups' scan."""
    k_cand, k_grp = jax.random.split(k_model)
    k_lam, k_cat, k_col = jax.random.split(k_grp, 3)
    n = jenv.max_num_objects
    return dict(
        cand=np.asarray(jax.random.choice(k_cand, jenv.bank.num_candidates, (n,),
                                          replace=jenv.constants.sample_with_replacement)),
        lam_u=jax.random.uniform(k_lam, (), jnp.float32),
        gumbel=np.stack([np.asarray(jax.random.gumbel(k, (n,), jnp.float32))
                         for k in jax.random.split(k_cat, n)]),
        color_u=np.asarray(jax.random.uniform(k_col, (n, 3), jnp.float32)))


def jax_reset_draws(jenv, keys):
    """The port's `reset` draws from the JAX reset keys (blocks.py:384-438)."""
    per = []
    for key in keys:
        k_place, k_rot, _, k_goal, k_pause, k_state, k_model = jax.random.split(key, 7)
        per.append(dict(
            place_u=np.stack([np.asarray(jax.random.uniform(k, (20, 2), jnp.float32))
                              for k in jax.random.split(k_place, O)]),
            place_rot_u=np.asarray([jax.random.uniform(k, ()) for k in jax.random.split(k_rot, O)]),
            goal=_goal_draws(jenv, k_goal), pause_u=jax.random.uniform(k_pause, ()),
            **_mask_draws(jenv, k_goal, k_state), **_model_draws(jenv, k_model)))
    return _stack(per)


def _nudge(d, seed):
    gen = torch.Generator().manual_seed(seed)
    return d.replace(qvel=d.qvel + NUDGE * torch.randn(d.qvel.shape, generator=gen,
                                                       dtype=d.qvel.dtype))


@contextlib.contextmanager
def nudged_settle(seed):
    """Inside, the full-model goal settle (`_settle_in_model`) starts from
    velocities nudged by NUDGE."""
    physics, settle = t_blocks.physics, t_blocks.BlocksRearrangeEnv._settle_in_model
    shim = types.SimpleNamespace(step_n=lambda m, d, n: physics.step_n(m, _nudge(d, seed), n))

    def nudged(self, *args, **kw):
        t_blocks.physics = shim
        try:
            return settle(self, *args, **kw)
        finally:
            t_blocks.physics = physics

    t_blocks.BlocksRearrangeEnv._settle_in_model = nudged
    try:
        yield
    finally:
        t_blocks.BlocksRearrangeEnv._settle_in_model = settle


def port_reset(env, draws, n=3):
    """The port's reset, and its runs from the initial state's velocities
    nudged by NUDGE, the goal settle's too."""
    out = env.reset(B, draws)
    d0, nudged = env._initial_data, []
    for s in range(n):
        env._initial_data = _nudge(d0, s)
        try:
            with nudged_settle(100 + s):
                nudged.append(env.reset(B, draws)[0])
        finally:
            env._initial_data = d0
    return out, nudged


def port_step(env, tstate, action, draws, n=3):
    """The port's step, its runs from both sims' velocities nudged by
    NUDGE, the goal settle's too, and its run in float64."""
    out = env.step(tstate, action, draws=draws)
    nudged = []
    for s in range(n):
        st = tstate.replace(physics=_nudge(tstate.physics, s),
                            goal_aux=_nudge(tstate.goal_aux, 50 + s))
        with nudged_settle(100 + s):
            nudged.append(env.step(st, action, draws=draws)[0])
    return out, nudged + [float64_step(env, tstate.replace(model_fields=tstate.model_fields or {}),
                                       action, draws)]


def _goal_state(goal):
    qpos = np.concatenate([_np(goal["obj_pos"]), _np(goal["obj_rot"])], -1)
    return {"qpos": qpos.reshape(qpos.shape[0], -1), "qvel": np.zeros((qpos.shape[0], 1))}


def compare_state(tstate, tobs, jstate, jobs, env, nudged, settled):
    """Physics by the nudge rule over the whole batch; a settled goal's
    poses the same way, else the goal 1e-6 abs; the obs on the envs within
    every envelope. Returns those envs."""
    td, jd = bridge.data_to_numpy(tstate.physics), bridge.data_to_numpy(jstate.physics)
    assert_physics_close(td, jd, _objects(env), [bridge.data_to_numpy(n.physics) for n in nudged],
                         whole=True)
    calm = _within_envelope(td, jd, env)
    pose_keys = ("obj_pos", "obj_rot") if settled else ()
    if settled:
        tg, jg = _goal_state(tstate.goal), _goal_state(jstate.goal)
        assert_physics_close(tg, jg, GOAL_IDX, [_goal_state(n.goal) for n in nudged], whole=True)
        for _, field, cols, tol in _groups(GOAL_IDX):
            calm &= _env_err(tg, jg, field, cols) <= tol
    assert sorted(tstate.goal) == sorted(jstate.goal)
    for k, v in jstate.goal.items():
        if k in pose_keys:
            continue
        if settled and k in ("goal_objects_in_placement_area", "goal_in_placement_area"):
            np.testing.assert_array_equal(_np(tstate.goal[k])[calm], np.asarray(v)[calm], err_msg=k)
        else:
            _close(tstate.goal[k], v, 1e-6, msg=k)
    assert sorted(tobs) == sorted(jobs)
    for k in tobs:
        t, j = _np(tobs[k]), np.asarray(jobs[k])
        assert t.shape == j.shape and np.isfinite(t).all(), k
        if k in ("tcp_force", "tcp_torque", "safety_stop", "obj_gripper_contact"):
            continue        # contact forces: checked by test_torch_rearrange.py on one state
        _close(t[calm], j[calm], 2 * QPOS_TOL if k in EULER else _obs_tol(k), msg=k)
    return calm


def compare_step(tout, jout, env, nudged, settled):
    (ts, tobs, trew, tdone, tinfo), (js, jobs, jrew, jdone, jinfo) = tout, jout
    calm = compare_state(ts, tobs, js, jobs, env, nudged, settled)
    np.testing.assert_array_equal(_np(trew)[calm], np.asarray(jrew)[calm])
    np.testing.assert_array_equal(_np(tdone)[calm], np.asarray(jdone)[calm])
    for k in tinfo:
        t, j = _np(tinfo[k]), np.asarray(jinfo[k])
        if t.dtype.kind == "f":
            _close(t[calm], j[calm], 1e-6, msg=k)
        else:
            np.testing.assert_array_equal(t[calm], j[calm], err_msg=k)
    for f in dataclasses.fields(t_core.TrackerState):
        np.testing.assert_array_equal(_np(getattr(ts.tracker, f.name))[calm],
                                      np.asarray(getattr(js.tracker, f.name))[calm],
                                      err_msg=f.name)
    return calm


# ---------------------------------------------------------------------------
# the bank, the model fields, the per-env hulls
# ---------------------------------------------------------------------------

def test_stand_in_files_and_world_match_their_writers(tmp_path):
    """The committed candidate STLs are what `write_candidates` writes, and
    `rearrange_ycb_like.npz` what the snapshot tool compiles now: 8 mesh
    slots (nv = 60), each owning its mesh, and no box-box pair."""
    written = rearrange_ycb_like.write_candidates(str(tmp_path))
    for name, path in written.items():
        with open(path) as a, open(os.path.join(rearrange_ycb_like.MESH_DIR, name,
                                                f"{name}.stl")) as b:
            assert a.read() == b.read(), name
    tool = snapshot_tool()
    _, fresh = tool.compile_snapshot("rearrange_ycb_like")
    with np.load(rearrange_ycb_like.SNAPSHOT) as z:
        assert sorted(fresh) == sorted(z.files)
        for k in z.files:
            assert np.array_equal(fresh[k], z[k]), k
    m = t_blocks._load(rearrange_ycb_like.SNAPSHOT, "cpu")
    assert m.const.nv == 60
    gids = [m.const.names["geom"][f"object{i}"] for i in range(8)]
    assert len({int(m.const.geom_dataid[g]) for g in gids}) == 8
    kinds = {(g["kind"], g["t1"], g["t2"]) for g in t_driver.build_groups(m.const,
                                                                         m.opt.group_cap)}
    assert not any(t1 == t2 == GeomType.BOX for _, t1, t2 in kinds), kinds


def test_bank_matches_jax():
    """`MeshObjectBank.build` on all six stand-in candidates against the JAX
    bank: names, padded hulls and masks exactly, mass, inertia, frame and
    bbox 1e-6 relative; the bridge carries the JAX bank across bit for
    bit; the hulls are normalised (largest half-extent 0.05), the banana's
    and the bottle's cut to 64 verts, the die's padded."""
    files = t_mesh.find_meshes_by_dirname(rearrange_ycb_like.MESH_DIR)
    jb = j_mesh.MeshObjectBank.build(files)
    tb = t_mesh.MeshObjectBank.build(files)
    assert tb.names == jb.names == ("banana", "bottle", "bowl", "can", "cracker_box", "die")
    assert np.array_equal(_np(tb.hull_vert), np.asarray(jb.hull_vert))
    assert np.array_equal(_np(tb.hull_mask), np.asarray(jb.hull_mask))
    for k in ("mass", "inertia", "iquat", "bbox_half"):
        np.testing.assert_allclose(_np(getattr(tb, k)), np.asarray(getattr(jb, k)), rtol=1e-6,
                                   atol=0, err_msg=k)
    carried = bridge.mesh_bank_from_numpy(jb, "cpu")
    for f in dataclasses.fields(carried):
        if f.name != "names":
            assert np.array_equal(_np(getattr(carried, f.name)), np.asarray(getattr(jb, f.name)))
    mask = _np(tb.hull_mask) > 0
    assert mask.sum(-1).tolist() == [64, 64, 64, 64, 64, 12]
    half = np.asarray([(h[m].max(0) - h[m].min(0)) / 2 for h, m in zip(_np(tb.hull_vert), mask)])
    np.testing.assert_allclose(half.max(-1), 0.05, rtol=1e-6)


def test_reset_model_fields_match_jax(port_env, jax_env):
    """`_reset_model_fields` on the JAX keys' draws (candidates with
    replacement and the colour groups) gives the JAX fields, the objects'
    half-sizes and group ids exactly; the fields' slot rows are the bank's
    rows of the drawn candidates."""
    keys = jax.random.split(jax.random.PRNGKey(3), 8)
    want_f, want_s, want_g = jax.vmap(jax_env._reset_model_fields)(keys)
    draws = _stack([_model_draws(jax_env, k) for k in keys])
    got_f, got_s, got_g = port_env._reset_model_fields(draws, 8)
    assert sorted(got_f) == sorted(want_f)
    for k, v in want_f.items():
        assert np.array_equal(_np(got_f[k]), np.asarray(v)), k
    assert np.array_equal(_np(got_s), np.asarray(want_s))
    assert np.array_equal(_np(got_g), np.asarray(want_g))
    cand = _np(draws["cand"])
    assert len(np.unique(cand)) == 3
    hv = _np(got_f["mesh_convex_vert"])[:, port_env._slot_mesh_ids]
    assert np.array_equal(hv, _np(port_env.bank.hull_vert)[cand])


def _posed_state(env, reset, seed):
    """The JAX reset's state with object 1 pressed onto object 0 (centres
    0.03 m apart, a random direction in the upper half), so that their
    per-env hulls meet; and the JAX reset state's model fields."""
    jstate, _ = reset(jax.random.split(jax.random.PRNGKey(seed), B))
    arrays = {k: np.array(v) for k, v in bridge.data_to_numpy(jstate.physics).items()}
    rng = np.random.default_rng(seed)
    adr = env.idx.object_qpos_adr
    u = rng.normal(size=(B, 3))
    u[:, 2] = np.abs(u[:, 2]) + 0.5
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    arrays["qpos"][:, adr[1]:adr[1] + 3] = arrays["qpos"][:, adr[0]:adr[0] + 3] + 0.03 * u
    return arrays, jstate.model_fields


def test_per_env_hulls_match_jax_collision(port_env, jax_env, jax_fns):
    """The contact table of a state whose two objects overlap, each env
    with its own hulls (`mesh_convex_vert` per env), against the JAX
    package's `fwd_position` under `jax.vmap` with the same per-env fields:
    the driver's mesh tables and capsules are each env's own, and its live
    mesh-mesh and plane-mesh contacts equal the JAX package's."""
    arrays, jfields = _posed_state(port_env, jax_fns[0], 4)
    jd = jax.jit(jax.vmap(lambda f, d: j_step.fwd_position(
        j_core.apply_model_fields(jax_env.model, f), d)))(jfields, jax.tree_util.tree_map(
            jnp.asarray, _jax_data(arrays)))
    fields = {k: _t(v) for k, v in jfields.items()}
    tm = t_core.apply_model_fields(port_env.model, fields)
    td = t_step.fwd_position(tm, bridge.data_from_numpy(arrays, "cpu"))
    _compare_tables(tm, jd, td)
    cache = t_driver._model_cache(tm, tm.opt.group_cap)
    vloc = _np(cache["mesh"][0])
    assert vloc.shape[0] == B
    slots = port_env.idx.object_geom_ids
    assert not np.array_equal(vloc[0, slots], vloc[1, slots]) or \
        not np.array_equal(vloc[0, slots], vloc[2, slots])
    live = _np(td.contact.active)
    g1, g2 = _np(td.contact.geom1), _np(td.contact.geom2)
    both = np.isin(g1, slots) & np.isin(g2, slots) & live
    assert both.any(axis=1).all(), "the objects' hulls meet in every env"


def _jax_data(arrays):
    from _torch_common import jax_data_from_numpy

    return jax_data_from_numpy(arrays)


# ---------------------------------------------------------------------------
# the env: reset, steps, a forced resample with the mesh goal settle
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def run(port_env, jax_env, jax_fns):
    """The JAX reset of seed 5 and the port's reset on its draws; then
    three steps, each from the JAX state carried across, actions uniform in
    [-1, 1]: [(port's output, its nudged runs, JAX's output)]."""
    reset, step = jax_fns
    keys = jax.random.split(jax.random.PRNGKey(5), B)
    jstate, jobs = reset(keys)
    out = [(port_reset(port_env, jax_reset_draws(jax_env, keys)), (jstate, jobs))]
    rng = np.random.default_rng(5)
    for _ in range(3):
        action = rng.uniform(-1, 1, (B, port_env.action_size)).astype(np.float32)
        tout = port_step(port_env, _to_port(jstate), _t(action),
                         jax_step_draws(jax_env, jstate))
        jout = step(jstate, jnp.asarray(action))
        out.append((tout, jout))
        jstate = jout[0]
    return out, step, jstate


def test_reset_matches_jax(run, port_env):
    """The reset: each env's candidates' fields, the objects placed and
    settled under them, the first goal settled in the full model, by the
    nudge rule; every env settled once."""
    ((tstate, tobs), nudged), (jstate, jobs) = run[0][0]
    compare_state(tstate, tobs, jstate, jobs, port_env, nudged, settled=True)
    for k, v in jstate.model_fields.items():
        assert np.array_equal(_np(tstate.model_fields[k]), np.asarray(v)), k


@pytest.mark.parametrize("i", [1, 2, 3])
def test_steps_match_jax(run, port_env, i):
    """Each of the three steps from the JAX state, by the nudge rule."""
    (tout, nudged), jout = run[0][i]
    compare_step(tout, jout, port_env, nudged, settled=False)


def test_forced_resample_settles_only_the_resampling_envs(run, port_env, jax_env):
    """A step in which envs 0 and 2 resample their goal: their new goals
    settled in the full model from their own states, by the nudge rule,
    env 1's kept; the settle ran once, on those two envs only."""
    _, step, jstate = run
    jstate = jstate.replace(tracker=jstate.tracker.replace(
        success_and_no_goal_reset=jnp.asarray([True, False, True])))
    action = np.random.default_rng(12).uniform(-1, 1, (B, port_env.action_size)).astype(
        np.float32)
    jout = step(jstate, jnp.asarray(action))
    settles, envs = port_env.goal_settles, port_env.goal_settle_envs
    tout, nudged = port_step(port_env, _to_port(jstate), _t(action),
                             jax_step_draws(jax_env, jstate))
    assert (port_env.goal_settles - settles, port_env.goal_settle_envs - envs) == (5, 10)
    compare_step(tout, jout, port_env, nudged, settled=True)
    moved = np.abs(_np(tout[0].goal["obj_pos"]) - np.asarray(jstate.goal["obj_pos"])).max((1, 2))
    assert moved[0] > 0 and moved[1] == 0 and moved[2] > 0


def test_pickandplace_reset_and_step_match_jax(jax_env):
    """YCB pick-and-place: the JAX env as its `make_env` builds it (a copy
    of the YCB env with the pick-and-place goal, no goal settle) against
    the port's `ycb_pickandplace.make_env`: reset and one step; the first
    object's goal is in the air."""
    jenv = copy.copy(jax_env)
    jenv.constants = dataclasses.replace(jax_env.constants, goal_generation="pickandplace",
                                         goal_args=())
    jenv.goal_gen = j_goals.PickAndPlaceGoal(jax_env.idx, j_goals.GoalArgs(),
                                             used_table_portion=1.0)
    env = from_jax_start(t_ycb_pp.make_env({"mujoco_substeps": 2}, PARAMETERS, mesh_names=NAMES,
                                           mesh_files_by_name=port_files(), device="cpu",
                                           worlds=port_worlds(jax_env)), jax_env)
    assert type(env.goal_gen).__name__ == "PickAndPlaceGoal"
    keys = jax.random.split(jax.random.PRNGKey(8), B)
    jstate, jobs = jax.jit(jax.vmap(jenv.reset))(keys)
    (tstate, tobs), nudged = port_reset(env, jax_reset_draws(jenv, keys))
    compare_state(tstate, tobs, jstate, jobs, env, nudged, settled=False)
    _, _, top = env.idx.table_dimensions()
    assert (_np(tstate.goal["obj_pos"])[:, 0, 2] > top + 0.05 - 1e-6).all()
    action = np.random.default_rng(8).uniform(-1, 1, (B, env.action_size)).astype(np.float32)
    tout, nudged = port_step(env, _to_port(jstate), _t(action), jax_step_draws(jenv, jstate))
    compare_step(tout, jax.jit(jax.vmap(jenv.step))(jstate, jnp.asarray(action)), env, nudged,
                 settled=False)


def test_new_modules_import_neither_jax_nor_the_jax_package():
    code = (
        "import sys\n"
        "import robogym_torch.envs.rearrange.mesh, robogym_torch.envs.rearrange.ycb\n"
        "import robogym_torch.envs.rearrange.ycb_pickandplace, robogym_torch.mjcf.mesh\n"
        "import robogym_torch.envs.rearrange.holdout, robogym_torch.utils.env_utils\n"
        "import robogym_torch.utils.jsonnet, robogym_torch.worlds.rearrange_ycb_like\n"
        "import robogym_torch.worlds.holdout_ball_like\n"
        "bad = [m for m in sys.modules if m.startswith(('jax', 'robogym_tpu'))]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
