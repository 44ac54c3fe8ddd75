"""Shared pieces of the port's tests (tests/test_torch_*.py).

Both packages get the same compiled model and the same state, carried
across as numpy by `robogym_torch.bridge`. The JAX side runs in float32 on
the CPU, through the reference paths its dispatches take there. JAX is
imported inside the functions that need it, so the tests that need the card
run where JAX is not installed.
"""

import contextlib
import dataclasses
import functools
import os

import numpy as np
import torch

import chip_smoke
from robogym_torch import bridge
from robogym_torch.mjcf.model import OPTION_TENSORS, make_data
from robogym_torch.physics import step as torch_step
from robogym_torch.worlds import blocks_settle_like, locked_like

# The port's tensors here are a few envs wide: one thread per test process
# runs them fastest, and keeps parallel test workers from oversubscribing
# the cores.
torch.set_num_threads(1)

BALL_BOX = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 1" pos="0 0 0"/>
    <body name="ball" pos="0 0 0.2">
      <freejoint name="ball_j"/>
      <geom name="ball" type="sphere" size="0.05" density="1000"/>
    </body>
    <body name="box" pos="0.02 0 0.32">
      <freejoint name="box_j"/>
      <geom name="box" type="box" size="0.04 0.04 0.04" density="500"/>
    </body>
  </worldbody>
</mujoco>
"""


@contextlib.contextmanager
def jax_boxbox_kernel():
    """Inside, the JAX package's collision runs box-box pairs through its
    Pallas kernel in interpret mode (as tests/test_boxbox_kernel.py runs
    it), not through `primitives.box_box`, which its CPU dispatch takes
    otherwise. The port's box-box kernel transcribes the Pallas kernel, and
    the two differ on near-ties of the SAT depth (see
    `robogym_torch.physics.collision.boxbox_kernel`). Only the box-box
    dispatch is switched: the flags are set while its batching rule traces
    the kernel."""
    from robogym_tpu.physics.collision import boxbox_kernel as j_bb

    make_core = j_bb.make_core

    def forced(*args):
        old = j_bb.INTERPRET
        j_bb.INTERPRET = True
        os.environ["ROBOGYM_TPU_FORCE_PALLAS"] = "1"
        try:
            return make_core()(*args)
        finally:
            j_bb.INTERPRET = old
            os.environ.pop("ROBOGYM_TPU_FORCE_PALLAS", None)

    j_bb.make_core = lambda: forced
    try:
        yield
    finally:
        j_bb.make_core = make_core


def jax_model_from_numpy(arrays):
    """The JAX package's Model from a `bridge.model_to_numpy` dict."""
    import jax.numpy as jnp
    from robogym_tpu.mjcf import model as jm

    opt = jm.Option(**{n: jnp.asarray(arrays["opt." + n]) for n in OPTION_TENSORS},
                    **bridge.option_static(arrays))
    kw = {f.name: jnp.asarray(arrays["model." + f.name]) for f in dataclasses.fields(jm.Model)
          if "model." + f.name in arrays}
    return jm.Model(const=bridge.const_from_numpy(arrays, jm.ModelConst), opt=opt, **kw)


def jax_data_from_numpy(arrays):
    """The JAX package's batched Data from a `bridge.data_to_numpy` dict."""
    import jax.numpy as jnp
    from robogym_tpu.mjcf import model as jm

    contact = jm.Contact(**{f.name: jnp.asarray(arrays["contact." + f.name])
                            for f in dataclasses.fields(jm.Contact)})
    return jm.Data(contact=contact, **{f.name: jnp.asarray(arrays[f.name])
                                       for f in dataclasses.fields(jm.Data)
                                       if f.name != "contact"})


def to_jax(data):
    return jax_data_from_numpy(bridge.data_to_numpy(data))


def to_torch(data):
    return bridge.data_from_numpy(bridge.data_to_numpy(data), "cpu")


@functools.lru_cache(maxsize=1)
def locked_like_arrays():
    with np.load(locked_like.SNAPSHOT) as z:
        return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=1)
def locked_like_models():
    """(JAX Model, port Model on the CPU) of the committed snapshot."""
    return jax_model_from_numpy(locked_like_arrays()), locked_like_model()


@functools.lru_cache(maxsize=1)
def locked_like_model():
    """The port's Model of the committed snapshot, on the CPU."""
    return bridge.model_from_numpy(locked_like_arrays(), "cpu")


def locked_like_state(tm, batch: int, seed: int = 0, settle: int = 20):
    """Seeded start states, settled by the port's step on the CPU so that
    contacts are live."""
    qpos, ctrl = locked_like.initial_state(locked_like_arrays(), batch, seed)
    d = make_data(tm, batch, torch.as_tensor(qpos)).replace(ctrl=torch.as_tensor(ctrl))
    return torch_step.step_n(tm, d, settle)


@functools.lru_cache(maxsize=4)
def snapshot_arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@functools.lru_cache(maxsize=4)
def snapshot_model(path):
    """The port's Model of a committed snapshot, on the CPU."""
    return bridge.model_from_numpy(snapshot_arrays(path), "cpu")


@functools.lru_cache(maxsize=4)
def snapshot_jax_model(path):
    """The JAX package's Model of a committed snapshot."""
    return jax_model_from_numpy(snapshot_arrays(path))


def hand_state(batch: int, seed: int = 0, settle: int = 5):
    """The hand-only world (no collision pair) from seeded start states
    with about one hinge in eleven past a limit, so that joint-limit rows
    are live; settled by the port's step. Returns (port Model, Data)."""
    tm = snapshot_model(locked_like.HAND_SNAPSHOT)
    qpos, ctrl = locked_like.initial_state(snapshot_arrays(locked_like.HAND_SNAPSHOT), batch,
                                           seed, reach=1.1)
    d = make_data(tm, batch, torch.as_tensor(qpos)).replace(ctrl=torch.as_tensor(ctrl))
    return tm, torch_step.step_n(tm, d, settle)


def settle_state(batch: int, seed: int = 0, settle: int = 40, world=blocks_settle_like):
    """A goal-settle world (a module of `robogym_torch.worlds`: the blocks
    world by default, or `table_setting_like`) from seeded start states
    (objects 1 to 5 mm above the table; in the odd envs block 1 stacked on
    block 0, or the spoon on the plate), settled by the port's step for
    `settle` 1 ms substeps so that the objects rest on the table and on
    each other. Returns (port Model, Data)."""
    tm = snapshot_model(world.SNAPSHOT)
    qpos, _ = world.initial_state(snapshot_arrays(world.SNAPSHOT), batch, seed)
    return tm, torch_step.step_n(tm, make_data(tm, batch, torch.as_tensor(qpos)), settle)


@functools.lru_cache(maxsize=1)
def ball_box_models():
    import jax.numpy as jnp
    from robogym_tpu.mjcf.compiler import compile_xml

    jmod = compile_xml(BALL_BOX, dtype=jnp.float32)
    return jmod, bridge.model_from_numpy(bridge.model_to_numpy(jmod), "cpu")


def ball_box_state(tm, batch: int, settle: int = 160):
    """Ball and box dropped onto the floor at seeded heights, settled by
    the port's step so that the ball-box and floor contacts are live."""
    rng = np.random.default_rng(1)
    qpos = np.tile(tm.qpos0.numpy(), (batch, 1))
    qpos[:, 2] += rng.uniform(0.0, 0.01, batch)
    qpos[:, 9] += rng.uniform(0.0, 0.005, batch)
    d = make_data(tm, batch, torch.as_tensor(qpos))
    return torch_step.step_n(tm, d, settle)


def hull_inputs(tm, d):
    """The hull kernels' arguments as the collision driver builds them for
    state `d`: {"hull_pair": (args, DX), "hull_manifold": (args, DX)}."""
    from robogym_torch.physics.collision import convex_kernel

    got = {}
    with chip_smoke.recording(convex_kernel, ("hull_pair", "hull_manifold"), got):
        torch_step.fwd_position(tm, d)
    return {name: (args[:-1], args[-1]) for name, args in got.items()}


def core_inputs(tm, d):
    """The fused constraint core's inputs for state `d`:
    (kind_s, iterations, nfacet, args) as `fused_step_core` takes them."""
    from robogym_torch.physics import constraint

    d, qfrc_smooth = torch_step.forward_smooth(tm, d)
    kind_s, iterations, nfacet, args, _, _ = constraint.fused_core_inputs(tm, d, qfrc_smooth)
    return kind_s, iterations, nfacet, args


# envelope of an env step against a reference (test_torch_step.py's
# `test_env_step_matches_jax_locked_like`): m, quaternion entries and
# radians, rad/s and m/s
CUBE_POS_TOL, QPOS_TOL, QVEL_TOL = 2e-4, 1e-3, 5e-2
NUDGE = 1e-6        # m/s or rad/s on every start qvel, the nudged runs' perturbation
NUDGE_RATIO = 2     # drift from the reference over the largest nudged drift (test_torch_step.py)


def _groups(idx):
    """(name, field, columns, envelope) of the physics comparison; no cube
    group where `idx` is None (a world with no cube)."""
    cube = () if idx is None else (("cube position", "qpos", idx.cube_pos_qpos, CUBE_POS_TOL),)
    return cube + (("qpos", "qpos", slice(None), QPOS_TOL), ("qvel", "qvel", slice(None), QVEL_TOL))


def _env_err(a, b, field, cols):
    return np.abs(a[field][:, cols] - b[field][:, cols]).max(-1)


def chaotic_envs(td, nudged, idx):
    """(B,) the envs whose own runs from start states nudged by NUDGE leave
    the envelope in some group: they sit on a discontinuity (a contact
    appearing, a line-search pick flipping), where float32 noise of any
    order moves the result as far."""
    out = np.zeros(td["qpos"].shape[0], bool)
    for _, field, cols, tol in _groups(idx):
        for tn in nudged:
            out |= _env_err(tn, td, field, cols) > tol
    return out


def assert_physics_close(td, jd, idx, nudged=(), whole=False, ref_nudged=()):
    """Two `data_to_numpy` states, the port's `td` and a reference's `jd`
    (the JAX package's, or the plain versions'): finite, and each env
    within the env-step envelope, except the `chaotic_envs` of the port's
    `nudged` runs and of the reference's own `ref_nudged` runs (every env
    if `whole`), whose largest drift from the reference per group may be
    at most NUDGE_RATIO times their largest nudged drift, each package's
    runs against its own result (the rule of test_torch_step.py's
    goal-settle envelopes); `idx` is the world's `CubeIndex`, or None for
    a world with no cube. Returns the chaotic envs."""
    assert np.isfinite(td["qpos"]).all() and np.isfinite(td["qvel"]).all()
    chaotic = chaotic_envs(td, nudged, idx) | chaotic_envs(jd, ref_nudged, idx) | whole
    for name, field, cols, tol in _groups(idx):
        err = _env_err(td, jd, field, cols)
        assert (err[~chaotic] <= tol).all(), (name, err, tol)
        if chaotic.any():
            drift = max([_env_err(tn, td, field, cols)[chaotic].max() for tn in nudged]
                        + [_env_err(rn, jd, field, cols)[chaotic].max() for rn in ref_nudged])
            assert err[chaotic].max() <= max(NUDGE_RATIO * drift, tol), (name, err, drift)
    return chaotic


def nudged_runs(run, qvel, n=3):
    """`run(qvel')` for n seeded draws qvel' = qvel + NUDGE * N(0, 1)."""
    return [run(qvel + NUDGE * torch.randn(qvel.shape, generator=torch.Generator().manual_seed(s),
                                           dtype=qvel.dtype).to(qvel.device))
            for s in range(n)]
