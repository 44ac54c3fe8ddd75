"""The port's raycast renderer (`robogym_torch/render/raycast.py`) against
the JAX package's (`robogym_tpu/render/raycast.py`), on the CPU.

The scene is tests/test_render.py's SCENE (a plane, a sphere, a box, a
cylinder, a capsule, two cameras) with an ellipsoid on a free joint, a
mesh (a hull of 12 verts written to `tmp_path`), a point light and a
directional light added; a copy without lights takes the no-light shade.
Both packages get the JAX compiler's model through the bridge and the
same states: B=3 envs whose free body sits at seeded poses, with per-env
model fields (camera pose and fovy, geom colours and sizes, light poses and
intensities, the headlight) applied in the JAX package under `jax.vmap`
(`envs.core.apply_model_fields`) and in the port as (B, ...) fields.
32-pixel images; each type's and the hull's intersection also alone.

Tolerances: float images within 1e-4 and uint8 images within 1 level on
at least 99.5 % of the pixels. The pixels that part are those where a ray
grazes a silhouette or two depths tie (the port takes the first of tied
geoms by argmin, the JAX package averages them), and each test reports
their count and where they lie when it fails."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robogym_torch import bridge
from robogym_torch.envs import core as t_core
from robogym_torch.render import raycast as t_ray
from robogym_tpu.envs import core as j_core
from robogym_tpu.mjcf.compiler import compile_xml
from robogym_tpu.mjcf.model import make_data as j_make_data
from robogym_tpu.physics import step as j_step
from robogym_tpu.render import raycast as j_ray
from test_render import SCENE

B, S = 3, 32
SHARE = 0.995
FLOAT_TOL = 1e-4

EXTRA = """
    <body name="egg" pos="0.5 -0.6 0.3">
      <freejoint name="egg_j"/>
      <geom name="egg" type="ellipsoid" size="0.15 0.1 0.2" rgba="1 0 1 1"/>
    </body>
    <body name="rock" pos="-0.5 -0.7 0.2">
      <geom name="rock" type="mesh" mesh="rock" rgba="0 1 1 1"/>
    </body>
    <geom name="ghost" type="box" size="0.1 0.1 0.1" pos="0 0 1.2" rgba="1 1 1 0.05"/>
"""
LIGHTS = """
    <light name="sun" directional="true" pos="0 0 4" dir="0.3 0.1 -1" diffuse="0.5 0.5 0.5"
           ambient="0.1 0.1 0.1"/>
    <light name="lamp" pos="1 1 2" diffuse="0.4 0.4 0.4" ambient="0.05 0.05 0.05"/>
"""


def _rock(directory):
    """A 12-vert hull (an irregular prism) as ASCII STL."""
    from robogym_torch.worlds import locked_like

    ang = np.linspace(0, 2 * np.pi, 7)[:-1]
    ring = np.stack([0.2 * np.cos(ang), 0.15 * np.sin(ang)], -1)
    verts = np.concatenate([np.c_[ring, np.full(6, -0.15)], np.c_[0.7 * ring, np.full(6, 0.2)]])
    path = os.path.join(directory, "rock.stl")
    with open(path, "w") as f:
        f.write(locked_like._stl(verts))
    return path


def _scene_xml(directory, lights=True):
    xml = SCENE.replace("  <worldbody>", f'  <asset><mesh name="rock" file="{_rock(directory)}"/>'
                        "</asset>\n  <worldbody>")
    return xml.replace("  </worldbody>", EXTRA + (LIGHTS if lights else "") + "  </worldbody>")


def _models(tmp_path, lights=True):
    jm = compile_xml(_scene_xml(str(tmp_path), lights), dtype=jnp.float32)
    tm = bridge.model_from_numpy(bridge.model_to_numpy(jm), "cpu")
    return jm, tm


def _states(jm, seed=0):
    """B states (JAX, port) with the egg at seeded poses, positioned."""
    rng = np.random.default_rng(seed)
    d = jax.vmap(lambda _: j_make_data(jm, dtype=jnp.float32))(jnp.arange(B))
    qpos = np.asarray(d.qpos).copy()
    qpos[:, :3] = [0.5, -0.6, 0.3] + rng.uniform(-0.2, 0.2, (B, 3))
    q = rng.standard_normal((B, 4))
    qpos[:, 3:7] = q / np.linalg.norm(q, axis=1, keepdims=True)
    jd = jax.vmap(lambda dd: j_step.fwd_position(jm, dd))(d.replace(qpos=jnp.asarray(qpos,
                                                                                   jnp.float32)))
    return jd, bridge.data_from_numpy(bridge.data_to_numpy(jd), "cpu")


def _fields(jm, seed=1):
    """Per-env model fields (numpy, (B, ...)): the cameras' poses and
    fovy, the geoms' colours and sizes, the lights and the headlight."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, scale in (("cam_pos", 0.05), ("cam_fovy", 3.0), ("geom_size", 0.02)):
        base = np.asarray(getattr(jm, k))
        out[k] = (base + scale * rng.uniform(-1, 1, (B,) + base.shape)).astype(np.float32)
    quat = np.asarray(jm.cam_quat) + 0.03 * rng.standard_normal((B,) + jm.cam_quat.shape)
    out["cam_quat"] = (quat / np.linalg.norm(quat, axis=-1, keepdims=True)).astype(np.float32)
    rgba = np.asarray(jm.geom_rgba)
    out["geom_rgba"] = np.concatenate([rng.uniform(0, 1, (B,) + rgba[:, :3].shape),
                                       np.broadcast_to(rgba[:, 3:], (B,) + rgba[:, 3:].shape)],
                                      -1).astype(np.float32)
    if jm.const.nlight:
        for k in ("light_pos", "light_dir"):
            base = np.asarray(getattr(jm, k))
            out[k] = (base + 0.2 * rng.uniform(-1, 1, (B,) + base.shape)).astype(np.float32)
        out["light_diffuse"] = rng.uniform(0.2, 0.8, (B, jm.const.nlight)).astype(np.float32)
    out["headlight_diffuse"] = rng.uniform(0.2, 0.6, B).astype(np.float32)
    out["headlight_ambient"] = rng.uniform(0.0, 0.2, B).astype(np.float32)
    return out


def _jax_render(jm, jd, cam, fields=None, vis=None, uint8=False):
    fn = j_ray.render_uint8 if uint8 else j_ray.render_rgb

    def one(dd, ff):
        m = j_core.apply_model_fields(jm, ff) if ff is not None else jm
        return fn(m, dd, cam, S, S, vis)

    f = None if fields is None else {k: jnp.asarray(v) for k, v in fields.items()}
    return np.asarray(jax.vmap(one)(jd, f))


def _port_render(tm, td, cam, fields=None, vis=None, uint8=False):
    m = tm if fields is None else t_core.apply_model_fields(
        tm, {k: torch.as_tensor(v) for k, v in fields.items()})
    fn = t_ray.render_uint8 if uint8 else t_ray.render_rgb
    return fn(m, td, cam, S, S, None if vis is None else torch.as_tensor(np.asarray(vis))).numpy()


def assert_images_close(got, want, what):
    """Float images within FLOAT_TOL, uint8 within 1 level, each on at
    least SHARE of the pixels; the message names the pixels that part."""
    tol = 1 if got.dtype == np.uint8 else FLOAT_TOL
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64)).max(-1)
    off = diff > tol
    share = 1.0 - off.mean()
    where = np.argwhere(off)[:8].tolist()
    assert share >= SHARE, (f"{what}: {int(off.sum())} of {off.size} pixels part (largest "
                            f"{diff.max():.3g}), first at (env, row, col) {where}")
    assert got.shape == want.shape and got.dtype == want.dtype


@pytest.mark.parametrize("lights", [True, False])
@pytest.mark.parametrize("cam", [0, 1])
def test_render_matches_jax(tmp_path, lights, cam):
    jm, tm = _models(tmp_path, lights)
    jd, td = _states(jm)
    for uint8 in (False, True):
        got = _port_render(tm, td, cam, uint8=uint8)
        want = _jax_render(jm, jd, cam, uint8=uint8)
        assert_images_close(got, want, f"cam {cam} lights {lights} uint8 {uint8}")
    # every geom type is in view of one of the cameras: the image is not
    # the background alone
    assert (got.astype(int).std(axis=(1, 2)) > 5).all()


@pytest.mark.parametrize("cam", [0, 1])
def test_per_env_fields_reach_the_image(tmp_path, cam):
    jm, tm = _models(tmp_path)
    jd, td = _states(jm)
    fields = _fields(jm)
    for uint8 in (False, True):
        got = _port_render(tm, td, cam, fields, uint8=uint8)
        want = _jax_render(jm, jd, cam, fields, uint8=uint8)
        assert_images_close(got, want, f"cam {cam} per-env fields uint8 {uint8}")
    plain = _port_render(tm, td, cam, uint8=True)
    assert (np.abs(got.astype(int) - plain.astype(int)).max(axis=(1, 2, 3)) > 10).all()


def test_visibility_mask_hides_geoms(tmp_path):
    jm, tm = _models(tmp_path)
    jd, td = _states(jm)
    names = jm.const.names["geom"]
    vis = np.ones(jm.const.ngeom, np.float32)
    vis[[names["ball"], names["rock"]]] = 0.0
    got = _port_render(tm, td, 0, vis=vis, uint8=True)
    want = _jax_render(jm, jd, 0, vis=jnp.asarray(vis), uint8=True)
    assert_images_close(got, want, "visibility mask")
    r, g, b = (got[..., i].astype(int) for i in range(3))
    assert ((r > 1.5 * g + 20) & (r > 1.5 * b + 20)).sum() == 0
    # a per-env mask: env 1 hides nothing
    per_env = np.stack([vis, np.ones_like(vis), vis])
    got2 = _port_render(tm, td, 0, vis=per_env, uint8=True)
    np.testing.assert_array_equal(got2[0], got[0])
    np.testing.assert_array_equal(got2[1], _port_render(tm, td, 0, uint8=True)[1])


TYPES = ("plane", "sphere", "capsule", "cylinder", "ellipsoid", "box")


@pytest.mark.parametrize("kind", TYPES + ("hull",))
def test_intersections_match_jax(kind):
    """Each type's intersection on seeded rays in the geom's frame (two
    geoms, 400 rays from outside): depths and normals where both hit,
    1e-4; hit or miss the same but on grazing rays (1 %)."""
    rng = np.random.default_rng(TYPES.index(kind) if kind in TYPES else 9)
    G, P = 2, 400
    size = rng.uniform(0.1, 0.4, (G, 3)).astype(np.float32)
    o = (rng.standard_normal((G, 3)) * 0.3 + [0.0, 0.0, 1.5]).astype(np.float32)
    target = rng.uniform(-0.4, 0.4, (G, P, 3))
    v = target - o[:, None, :]
    v = (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)
    if kind == "hull":
        from robogym_tpu.mjcf import mesh as j_mesh

        pts = rng.standard_normal((20, 3)) * 0.3
        planes = j_mesh.hull_face_planes(pts, 64).astype(np.float32)
        F = len(planes)
        planes = np.concatenate([planes, np.zeros((64 - F, 4), np.float32)])
        mask = (np.arange(64) < F).astype(np.float32)
        jp, jmk = np.broadcast_to(planes, (G, 64, 4)), np.broadcast_to(mask, (G, 64))
        want_t, want_n = j_ray._isect_hull(jnp.asarray(jp), jnp.asarray(jmk), jnp.asarray(o),
                                           jnp.asarray(v))
        got_t, got_n = t_ray._isect_hull(torch.as_tensor(np.array(jp))[None],
                                         torch.as_tensor(np.array(jmk))[None],
                                         torch.as_tensor(o)[None], torch.as_tensor(v)[None])
    else:
        gt = getattr(__import__("robogym_tpu.mjcf.model", fromlist=["GeomType"]).GeomType,
                     kind.upper())
        want_t, want_n = j_ray._ISECT[gt](jnp.asarray(size), jnp.asarray(o), jnp.asarray(v))
        got_t, got_n = t_ray._ISECT[gt](torch.as_tensor(size)[None], torch.as_tensor(o)[None],
                                        torch.as_tensor(v)[None])
    got_t, got_n = got_t[0].numpy(), got_n[0].numpy()
    want_t, want_n = np.asarray(want_t), np.asarray(want_n)
    hit_g, hit_w = got_t < t_ray.BIG, want_t < j_ray.BIG
    assert (hit_g != hit_w).mean() <= 0.01
    both = hit_g & hit_w
    assert both.sum() > 20
    np.testing.assert_allclose(got_t[both], want_t[both], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got_n[both], want_n[both], rtol=0, atol=1e-4)


def test_camera_pose_and_lookat_match_jax(tmp_path):
    jm, tm = _models(tmp_path)
    jd, td = _states(jm)
    for cam in range(jm.const.ncam):
        jp, jmat = jax.vmap(lambda dd: j_ray.camera_pose(jm, dd, cam))(jd)
        tp, tmat = t_ray.camera_pose(tm, td, cam)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
        np.testing.assert_allclose(tmat.numpy(), np.asarray(jmat), rtol=0, atol=1e-6)
    e, mt = t_ray.lookat_pose((1.0, 2.0, 1.5), (0.0, 0.0, 0.2))
    je, jmt = j_ray.lookat_pose((1.0, 2.0, 1.5), (0.0, 0.0, 0.2))
    np.testing.assert_allclose(mt.numpy(), np.asarray(jmt), rtol=0, atol=1e-6)
    # a pose render from the look-at camera, on one env
    got = t_ray.render_rgb_pose(tm, td, e.expand(B, 3), mt.expand(B, 3, 3),
                                torch.full((B,), 45.0), S, S).numpy()
    want = np.asarray(jax.vmap(lambda dd: j_ray.render_rgb_pose(jm, dd, je, jmt, 45.0, S, S))(jd))
    assert_images_close(got, want, "look-at pose")


def test_render_chunks_envs_the_same(tmp_path, monkeypatch):
    """Envs taken in chunks give the images of one pass."""
    jm, tm = _models(tmp_path)
    _, td = _states(jm)
    whole = t_ray.render_uint8(tm, td, 0, S, S)
    monkeypatch.setattr(t_ray, "env_chunk", lambda m, b, p: 2)
    fields = {k: torch.as_tensor(v) for k, v in _fields(jm).items()}
    m = t_core.apply_model_fields(tm, fields)
    chunked = t_ray.render_uint8(tm, td, 0, S, S)
    np.testing.assert_array_equal(chunked.numpy(), whole.numpy())
    assert t_ray.LAST_CHUNK == {"envs": 2, "batch": B}
    per_env = t_ray.render_uint8(m, td, 1, S, S)
    monkeypatch.setattr(t_ray, "env_chunk", lambda m, b, p: b)
    np.testing.assert_array_equal(per_env.numpy(), t_ray.render_uint8(m, td, 1, S, S).numpy())
