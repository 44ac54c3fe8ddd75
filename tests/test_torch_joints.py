"""Slide and ball joints in the port against the JAX package, on an inline
world: a carriage on a limited, sprung slide, a slide on a slanted axis
below it, a ball-jointed box hanging from that with a site, and a cube on
three slides and a ball (as dactyl/locked's cube is) resting on the floor.
The smooth phase (tests/test_torch_smooth.py's fields and tolerance, 1e-5
abs, plus `site_xpos` and `site_xmat`), `invweight0` (1e-5 relative to each
array's largest entry: both invert the same float32 M in float64), and one
substep with live contacts (tests/test_torch_step.py's 1e-4 abs on qpos and
qvel)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import to_jax
from robogym_torch import bridge
from robogym_torch.mjcf.model import make_data
from robogym_torch.physics import setconst as t_setconst
from robogym_torch.physics import step as t_step
from robogym_tpu.mjcf.compiler import compile_xml
from robogym_tpu.physics import setconst as j_setconst
from test_torch_smooth import FIELDS, _jax_smooth, _torch_smooth
from test_torch_step import _jax_step

SLIDE_BALL = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1" pos="0 0 0"/>
    <body name="carriage" pos="0 0 0.4">
      <joint name="sx" type="slide" axis="1 0 0" damping="0.5" stiffness="20" springref="0.02"
             limited="true" range="-0.05 0.05"/>
      <geom name="carriage" type="box" size="0.03 0.03 0.01" density="800"
            contype="0" conaffinity="0"/>
      <body name="lift" pos="0 0 -0.02">
        <joint name="sz" type="slide" axis="0 0.6 0.8" damping="0.2" armature="0.01"/>
        <geom name="rod" type="capsule" fromto="0 0 0 0 0 -0.05" size="0.01"
              contype="0" conaffinity="0"/>
        <body name="bob" pos="0 0 -0.08">
          <joint name="bj" type="ball" damping="0.01"/>
          <geom name="bob" type="box" size="0.02 0.015 0.01" pos="0.02 0 -0.02" density="1000"/>
          <site name="tip" pos="0.04 0.01 -0.03"/>
        </body>
      </body>
    </body>
    <body name="cube" pos="0.15 0 0.03">
      <joint name="cube_tx" type="slide" axis="1 0 0"/>
      <joint name="cube_ty" type="slide" axis="0 1 0"/>
      <joint name="cube_tz" type="slide" axis="0 0 1"/>
      <joint name="cube_rot" type="ball"/>
      <geom name="cube" type="box" size="0.03 0.03 0.03" density="500"/>
      <site name="center" pos="0 0 0"/>
    </body>
  </worldbody>
</mujoco>
"""


@pytest.fixture(scope="module")
def models():
    jmod = compile_xml(SLIDE_BALL, dtype=jnp.float32)
    tm = bridge.model_from_numpy(bridge.model_to_numpy(jmod), "cpu")
    c = tm.const
    assert (c.nq, c.nv) == (1 + 1 + 4 + 3 + 4, 1 + 1 + 3 + 3 + 3)
    return jmod, tm


def _state(tm, batch, seed, settle=0):
    """Slides near their springs' rest, each ball at a seeded unit
    quaternion (the cube's tilted by at most about 0.1 rad so that it lands
    on an edge or a face), seeded qvel and ctrl; the cube 1 mm above the
    floor, then `settle` substeps of the port."""
    c = tm.const
    rng = np.random.default_rng(seed)
    qpos = np.tile(tm.qpos0.numpy(), (batch, 1))
    names = c.names["joint"]
    qpos[:, c.jnt_qposadr[names["sx"]]] = rng.uniform(-0.04, 0.04, batch)
    qpos[:, c.jnt_qposadr[names["sz"]]] = rng.uniform(-0.02, 0.02, batch)
    for name, spread in (("bj", 1.0), ("cube_rot", 0.05)):
        q = np.concatenate([np.ones((batch, 1)), spread * rng.standard_normal((batch, 3))], 1)
        a = c.jnt_qposadr[names[name]]
        qpos[:, a:a + 4] = q / np.linalg.norm(q, axis=1, keepdims=True)
    qpos[:, c.jnt_qposadr[names["cube_tz"]]] = 0.001
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    d = make_data(tm, batch, f32(qpos)).replace(qvel=f32(0.3 * rng.standard_normal((batch, c.nv))))
    return t_step.step_n(tm, d, settle) if settle else d


def test_smooth_matches_jax_slide_ball(models):
    jmod, tm = models
    d = _state(tm, 4, seed=0)
    jd = bridge.data_to_numpy(_jax_smooth(jmod)(to_jax(d)))
    td = bridge.data_to_numpy(_torch_smooth(tm, d))
    for k in FIELDS + ("site_xpos", "site_xmat"):
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=1e-5, err_msg=k)


def test_invweight0_matches_jax_slide_ball(models):
    jmod, tm = models
    got = t_setconst.compute_invweight0(tm)
    want = j_setconst.compute_invweight0(jmod)
    for name, g, w in zip(("dof", "body", "tendon"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = max(float(np.abs(w).max()) if w.size else 0.0, 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("seed", [0, 1])
def test_one_substep_matches_jax_slide_ball(models, seed):
    jmod, tm = models
    d = _state(tm, 4, seed=seed, settle=10)
    assert bool(d.contact.active.any())
    jd = bridge.data_to_numpy(_jax_step(jmod)(to_jax(d)))
    td = bridge.data_to_numpy(t_step.step(tm, d))
    for k in ("qpos", "qvel"):
        assert np.isfinite(td[k]).all()
        np.testing.assert_allclose(td[k], jd[k], rtol=0, atol=1e-4, err_msg=k)
