"""Replay: render recorded or live qpos trajectories offscreen.

Counterpart of `robogym_tpu/viewer/replay.py`. A card has no display, so
the viewer renders frames from the env's own Model: through the MuJoCo 3
Python bindings where they and a GL context are there, or through the
port's raycaster (`render/raycast.py`), eagerly on the env's device.
Frames come back as numpy images.

  * `render_trajectory(env, qpos_traj)` -> (T, H, W, 3) uint8 frames;
  * `replay_npz(env, path)` renders a `scripts/examine.py record=` dump;
  * `EnvReplayViewer(env).run(n_steps)` steps a batch of one env with
    random actions (or a policy) and renders each step.

The port's envs are batched, where the JAX package's are `jax.vmap`-ed by
the caller: the viewer drives a batch of one env.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Optional

import numpy as np
import torch


def _scrub_mj2_attrs(xml_str: str) -> str:
    """The source XML without the MuJoCo-2.0-era attributes that MuJoCo 3's
    schema rejects, without `fullinertia` beside an orientation (the
    diagonal kept: rendering needs kinematics only), and without
    actuators (user-gain actuators need a callback MuJoCo 3 lacks)."""
    root = ET.fromstring(xml_str)
    for opt in root.iter("option"):
        for bad in ("apirate", "collision", "impratio"):
            opt.attrib.pop(bad, None)
    for inert in root.iter("inertial"):
        if "fullinertia" in inert.attrib and (
            "quat" in inert.attrib or "euler" in inert.attrib
        ):
            full = inert.attrib.pop("fullinertia").split()
            inert.set("diaginertia", " ".join(full[:3]))
    for parent in root.iter():
        for act in list(parent):
            if act.tag == "actuator":
                parent.remove(act)
    return ET.tostring(root, encoding="unicode")


def _mj_model_for(env):
    """MuJoCo 3's model of the env's world, from its stashed source XML."""
    import mujoco

    xml_str = getattr(env.model.const, "_source_xml", None)
    if not xml_str:
        raise ValueError("the env's model has no stashed source XML")
    return mujoco.MjModel.from_xml_string(_scrub_mj2_attrs(xml_str))


def render_trajectory(
    env,
    qpos_traj: np.ndarray,
    width: int = 320,
    height: int = 240,
    camera: Optional[str] = None,
    backend: str = "auto",
) -> np.ndarray:
    """Render a (T, nq) qpos trajectory to (T, H, W, 3) uint8 frames.

    backend: "mujoco" (GL offscreen, needs MuJoCo 3 and EGL or OSMesa),
    "raycast" (the port's raycaster, on the env's device), or "auto"
    (mujoco, else raycast where `mujoco` is not installed or no GL context
    comes up)."""
    if backend == "raycast":
        return _render_trajectory_raycast(env, qpos_traj, width, height, camera)
    if backend == "auto":
        try:
            import mujoco
        except ImportError:
            return _render_trajectory_raycast(env, qpos_traj, width, height, camera)
        try:
            return _render_trajectory_mujoco(env, qpos_traj, width, height, camera)
        except mujoco.FatalError:           # no GL context
            return _render_trajectory_raycast(env, qpos_traj, width, height, camera)
    if backend != "mujoco":
        raise ValueError(f"unknown backend {backend!r}; want auto, mujoco or raycast")
    return _render_trajectory_mujoco(env, qpos_traj, width, height, camera)


def _render_trajectory_raycast(env, qpos_traj, width, height, camera) -> np.ndarray:
    """Forward kinematics and the raycaster, every frame of the trajectory
    one env of a batch, on the env's device. The named `<camera>` if
    given, camera 0 if the world has one, else a free camera looking at
    the centre of the geoms from outside their bounding sphere."""
    from robogym_torch.mjcf.model import make_data
    from robogym_torch.physics import step as phys
    from robogym_torch.render import raycast

    m = env.model
    q = torch.as_tensor(np.asarray(qpos_traj), dtype=m.dtype, device=m.device)
    d = phys.fwd_position(m, make_data(m, q.shape[0], q))
    if camera is not None:
        frames = raycast.render_uint8(m, d, raycast.camera_id(m, camera), height, width)
    elif m.const.ncam > 0:
        frames = raycast.render_uint8(m, d, 0, height, width)
    else:
        gp = d.geom_xpos[0].cpu().numpy()
        center = gp.mean(axis=0)
        radius = float(np.linalg.norm(gp - center, axis=1).max()) + 0.3
        eye = center + np.asarray([radius, -radius, 0.8 * radius])
        cpos, cmat = raycast.lookat_pose(eye, center, dtype=m.dtype, device=m.device)
        T = q.shape[0]
        fovy = torch.full((T,), 45.0, dtype=m.dtype, device=m.device)
        img = raycast.render_rgb_pose(m, d, cpos.expand(T, 3), cmat.expand(T, 3, 3), fovy,
                                      height, width)
        frames = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
    return frames.cpu().numpy()


def _render_trajectory_mujoco(
    env,
    qpos_traj: np.ndarray,
    width: int = 320,
    height: int = 240,
    camera: Optional[str] = None,
) -> np.ndarray:
    """MuJoCo 3's offscreen renderer (needs a GL context)."""
    import mujoco

    mj_model = _mj_model_for(env)
    mj_data = mujoco.MjData(mj_model)
    renderer = mujoco.Renderer(mj_model, height=height, width=width)
    frames = []
    cam = camera if camera is not None else -1
    for q in np.asarray(qpos_traj):
        mj_data.qpos[: mj_model.nq] = q[: mj_model.nq]
        mujoco.mj_forward(mj_model, mj_data)
        renderer.update_scene(mj_data, camera=cam)
        frames.append(renderer.render().copy())
    renderer.close()
    return np.stack(frames)


def replay_npz(env, npz_path: str, **kw) -> np.ndarray:
    """Render the qpos trajectory of a `scripts/examine.py record=` dump."""
    with np.load(npz_path) as data:
        qpos = data["qpos"]
    return render_trajectory(env, qpos, **kw)


def uniform_actions(env, generator: torch.Generator) -> torch.Tensor:
    """(1, action_size) uniform in [-1, 1] on the env's device."""
    return torch.rand((1, env.action_size), generator=generator, device=env.device,
                      dtype=env.dtype) * 2.0 - 1.0


class EnvReplayViewer:
    """The examine loop offscreen: step a batch of one env with random
    actions (or `policy(obs)`) and render every env step
    (env_viewer.py:122-141)."""

    def __init__(self, env, width: int = 320, height: int = 240):
        self.env = env
        self.width = width
        self.height = height

    def run(self, n_steps: int = 50, seed: int = 0, policy=None) -> np.ndarray:
        """(n_steps + 1, H, W, 3) uint8 frames: the reset state and each
        step's. `seed` seeds the env's draws and the actions' generator."""
        env = self.env
        env.generator.manual_seed(seed)
        state, obs = env.reset(1)
        gen = torch.Generator(device=env.device)
        gen.manual_seed(seed + 1)
        traj = [state.physics.qpos[0].cpu().numpy()]
        for _ in range(n_steps):
            if policy is None:
                action = uniform_actions(env, gen)
            else:
                action = torch.as_tensor(policy(obs), dtype=env.dtype,
                                         device=env.device).reshape(1, -1)
            state, obs, reward, done, info = env.step(state, action)
            traj.append(state.physics.qpos[0].cpu().numpy())
        return render_trajectory(env, np.stack(traj), width=self.width, height=self.height)
