"""Per-env model fields through the port's physics, against the JAX
package's vmapped step, on the dactyl-shaped world
(`robogym_torch/worlds/dactyl_locked_like.py`, nv = 36) at B=4.

Each of the twelve fields that the default dactyl wrapper stack overrides
(`robogym_tpu/wrappers/__init__.py:68-147`) is seeded per env with numpy,
about as far from the compiled value as the stack's distributions take it,
and laid over the model by `envs.core.apply_model_fields`; the JAX side
lays the same arrays over its model inside `jax.vmap`. One substep is held
to 1e-4 abs on qpos and qvel (test_torch_step.py's substep tolerance), one
10-substep `step_n` to the env-step envelope under the nudge rule
(`_torch_common.assert_physics_close`). A per-env field whose rows all
equal the shared field gives outputs equal to the shared model's, tensor
for tensor."""

import jax
import numpy as np
import pytest
import torch

from _torch_common import (assert_physics_close, jax_boxbox_kernel, nudged_runs,
                           snapshot_arrays, snapshot_jax_model, snapshot_model, to_jax)
from robogym_torch import bridge
from robogym_torch.envs import core as t_core
from robogym_torch.envs.dactyl import cube_env as t_cube
from robogym_torch.mjcf.model import make_data
from robogym_torch.physics import step as t_step
from robogym_torch.worlds import dactyl_locked_like
from robogym_tpu.envs import core as j_core
from robogym_tpu.physics import setconst as j_setconst
from robogym_tpu.physics import step as j_step

B = 4
FIELDS = ("geom_size", "body_pos", "body_inertia", "geom_friction", "site_pos", "dof_damping",
          "actuator_gainprm", "jnt_range", "actuator_ctrlrange", "tendon_range", "opt:gravity",
          "opt:timestep")


def _base(tm, name):
    return getattr(tm.opt, name[4:]) if name.startswith("opt:") else getattr(tm, name)


def seeded_fields(tm, seed=0):
    """{field: (B, ...) float32 numpy} for the twelve fields: sizes and
    inertias scaled by U[0.95, 1.05] and U[0.5, 1.5], friction, damping
    and kp by log-uniform factors, body and site positions moved by 1 mm
    and 3 mm normals, joint, control and tendon ranges widened by 15 % of
    their width (the tendons' by 0.1 rad: their compiled range is empty),
    gravity by 0.4 m/s^2 normals, the timestep in [1.5, 2.5] ms."""
    rng = np.random.default_rng(seed)
    out = {}
    for name in FIELDS:
        v = np.asarray(_base(tm, name).numpy(), np.float64)
        v = np.broadcast_to(v, (B,) + v.shape).copy()
        if name in ("geom_size", "body_inertia"):
            lo, hi = (0.95, 1.05) if name == "geom_size" else (0.5, 1.5)
            v *= rng.uniform(lo, hi, v.shape[:2] + (1,))
        elif name in ("geom_friction", "dof_damping"):
            v *= np.exp(rng.uniform(np.log(0.5), np.log(2.0), v.shape))
        elif name == "actuator_gainprm":
            v[..., 0] *= np.exp(rng.uniform(np.log(0.75), np.log(1.5), v.shape[:2]))
        elif name in ("body_pos", "site_pos"):
            v += rng.standard_normal(v.shape) * (1e-3 if name == "body_pos" else 3e-3)
        elif name in ("jnt_range", "actuator_ctrlrange", "tendon_range"):
            width = v[..., 1:] - v[..., :1] if name != "tendon_range" else 0.1
            new = v + width * 0.15 * rng.standard_normal(v.shape)
            v = np.stack([new.min(-1), new.max(-1)], -1)
        elif name == "opt:gravity":
            v += 0.4 * rng.standard_normal(v.shape)
        else:
            v = rng.uniform(1.5e-3, 2.5e-3, B)
        out[name] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def world():
    """(JAX Model, port Model, start states): seeded start states settled
    for 5 substeps by the port's shared model."""
    path = dactyl_locked_like.SNAPSHOT
    tm = snapshot_model(path)
    qpos, ctrl = dactyl_locked_like.initial_state(snapshot_arrays(path), B, 0)
    d = make_data(tm, B, torch.as_tensor(qpos)).replace(ctrl=torch.as_tensor(ctrl))
    return snapshot_jax_model(path), tm, t_step.step_n(tm, d, 5)


def _jax_steps(jm, fields, d, n):
    """n JAX substeps under `jax.vmap` with the per-env `fields`; the
    diagApprox weights come from the compiled model, as the JAX env's own
    construction computes them before any field is overridden."""
    j_setconst.invweight0(jm)
    step = jax.jit(jax.vmap(lambda mf, x: j_step.step(j_core.apply_model_fields(jm, mf), x)))
    mf = {k: jax.numpy.asarray(v) for k, v in fields.items()}
    jd = to_jax(d)
    with jax_boxbox_kernel():
        for _ in range(n):
            jd = step(mf, jd)
    return bridge.data_to_numpy(jd)


def _port_model(tm, fields):
    return t_core.apply_model_fields(tm, {k: torch.as_tensor(v) for k, v in fields.items()})


def test_seeded_fields_differ_across_envs(world):
    _, tm, _ = world
    for name, v in seeded_fields(tm).items():
        assert v.shape[0] == B and (v != v[:1]).any(), name
        assert (v != np.asarray(_base(tm, name).numpy())).any(), name


def test_one_substep_with_per_env_fields_matches_jax(world):
    jm, tm, d = world
    fields = seeded_fields(tm)
    m = _port_model(tm, fields)
    assert m.env_fields == frozenset(FIELDS)
    td = bridge.data_to_numpy(t_step.step(m, d))
    jd = _jax_steps(jm, fields, d, 1)
    assert td["contact.active"].any()
    for k in ("qpos", "qvel"):
        assert np.isfinite(td[k]).all()
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=1e-4, err_msg=k)
    np.testing.assert_allclose(td["time"], jd["time"], rtol=0, atol=1e-9)
    np.testing.assert_allclose(td["time"] - bridge.data_to_numpy(d)["time"],
                               fields["opt:timestep"], rtol=1e-6)


def test_step_n_with_per_env_fields_matches_jax(world):
    """10 substeps: the env-step envelope, under the nudge rule."""
    jm, tm, d = world
    fields = seeded_fields(tm, seed=1)
    m = _port_model(tm, fields)
    td = bridge.data_to_numpy(t_step.step_n(m, d, 10))
    jd = _jax_steps(jm, fields, d, 10)
    idx = t_cube.CubeIndex.build(tm)

    def run(qvel):
        return bridge.data_to_numpy(t_step.step_n(m, d.replace(qvel=qvel), 10))

    assert_physics_close(td, jd, idx, nudged_runs(run, d.qvel))


def test_per_env_fields_equal_to_shared_give_shared_outputs(world):
    """Every field per env with B equal rows: one substep equals the shared
    model's, tensor for tensor."""
    _, tm, d = world
    fields = {k: _base(tm, k).expand((B,) + tuple(_base(tm, k).shape)).clone() for k in FIELDS}
    got = bridge.data_to_numpy(t_step.step(t_core.apply_model_fields(tm, fields), d))
    want = bridge.data_to_numpy(t_step.step(tm, d))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
