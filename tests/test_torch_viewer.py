"""The port's viewer and scripts (`robogym_torch/viewer/`,
`robogym_torch/scripts/`) against the JAX package's, on the CPU.

`_scrub_mj2_attrs` gives the JAX string; the raycast `render_trajectory`
gives the JAX frames for the same qpos trajectory, on each of its three
cameras (a named camera, camera 0, the free look-at camera), within
tests/test_torch_render.py's tolerance (1 level on 99.5 % of the pixels);
`_mj_model_for` builds MuJoCo 3's model where `mujoco` imports; the
curses viewer's key handlers give the JAX handlers' actions, seeds and
selected dimension, in both modes, without curses; the examine script
runs the curses viewer under a pseudo-terminal, reads teleop commands from
stdin, and records the trajectory with the JAX script's keys and shapes;
`create_holdout` saves a state that both packages' holdout loaders read
back equal."""

import builtins
import dataclasses
import glob
import os
import pty
import select
import signal
import tempfile
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_common import jax_model_from_numpy
from robogym_torch import bridge
from robogym_torch.envs.rearrange import holdout as t_holdout
from robogym_torch.mjcf import compiler as t_compiler
from robogym_torch.mjcf import xml_tools as t_xml
from robogym_torch.robot import teleop as t_teleop
from robogym_torch.scripts import create_holdout as t_create
from robogym_torch.scripts import examine as t_examine
from robogym_torch.viewer import interactive as t_interactive
from robogym_torch.viewer import replay as t_replay
from robogym_torch.worlds import dactyl_assets_like, dactyl_locked_like, holdout_ball_like
from robogym_torch.worlds import vision_like
from robogym_tpu.envs.rearrange import blocks as j_blocks
from robogym_tpu.envs.rearrange import holdout as j_holdout
from robogym_tpu.mjcf import xml_tools as j_xml
from robogym_tpu.robot import teleop as j_teleop
from robogym_tpu.scripts import examine as j_examine
from robogym_tpu.viewer import interactive as j_interactive
from robogym_tpu.viewer import replay as j_replay
from test_torch_render import assert_images_close

H, W = 24, 32

OLD_XML = """
<mujoco>
  <option timestep="0.002" apirate="100" collision="all" impratio="2"/>
  <worldbody>
    <body name="b" pos="0 0 1">
      <freejoint/>
      <inertial pos="0 0 0" mass="1" fullinertia="0.1 0.2 0.3 0 0 0" quat="1 0 0 0"/>
      <geom name="g" type="sphere" size="0.1"/>
    </body>
    <body name="c" pos="0.3 0 0.2">
      <joint name="h" type="hinge" axis="0 1 0"/>
      <inertial pos="0 0 0" mass="1" fullinertia="0.1 0.2 0.3 0 0 0"/>
      <geom name="k" type="box" size="0.05 0.05 0.05"/>
    </body>
  </worldbody>
  <actuator>
    <motor name="m" joint="h"/>
  </actuator>
</mujoco>
"""

PRIMITIVES = """
<mujoco>
  <compiler angle="radian"/>
  <option timestep="0.002" gravity="0 0 -9.81"/>
  <worldbody>
    <geom name="floor" type="plane" size="1 1 0.1" rgba="0.6 0.6 0.6 1"/>
    <body name="ball" pos="0 0 0.2">
      <freejoint name="ball_j"/>
      <geom name="ball" type="sphere" size="0.05" rgba="1 0 0 1"/>
    </body>
    <body name="arm" pos="0.2 0 0.3">
      <joint name="hinge" type="hinge" axis="0 1 0"/>
      <geom name="arm" type="capsule" fromto="0 0 0 0.2 0 0" size="0.02" rgba="0 1 0 1"/>
    </body>
  </worldbody>
  <actuator>
    <position name="p" joint="hinge" kp="1"/>
  </actuator>
</mujoco>
"""


def test_scrub_matches_jax():
    """MuJoCo-2.0-era option attributes, `fullinertia` beside a `quat`, and
    the actuators: the port's scrub gives the JAX package's string."""
    got = t_replay._scrub_mj2_attrs(OLD_XML)
    assert got == j_replay._scrub_mj2_attrs(OLD_XML)
    assert "apirate" not in got and "actuator" not in got and 'diaginertia="0.1 0.2 0.3"' in got


def _trajectory(arrays, n=3, seed=0):
    """n qpos frames: qpos0 with every hinge and slide moved by a seeded
    uniform draw in [-0.2, 0.2] (ball quaternions kept)."""
    qpos0 = np.asarray(arrays["model.qpos0"], np.float32)
    types_ = np.asarray(arrays["const.jnt_type"])
    adr = np.asarray(arrays["const.jnt_qposadr"])
    cols = adr[(types_ == 2) | (types_ == 3)]
    rng = np.random.default_rng(seed)
    traj = np.repeat(qpos0[None], n, 0)
    traj[:, cols] += rng.uniform(-0.2, 0.2, (n, cols.size)).astype(np.float32)
    return traj


@pytest.mark.parametrize("camera", ["vision_cam_left", "camera 0", "look-at"])
def test_raycast_frames_match_jax(camera):
    """`render_trajectory(..., backend="raycast")` of a 3-frame trajectory
    against the JAX `_render_trajectory_raycast` on the same qpos: the
    dactyl-shaped world with vision cameras for a named camera and camera
    0, the world without cameras for the look-at camera."""
    snap = dactyl_locked_like.SNAPSHOT if camera == "look-at" else vision_like.DACTYL_SNAPSHOT
    with np.load(snap) as z:
        arrays = {k: z[k] for k in z.files}
    traj = _trajectory(arrays)
    name = camera if camera.startswith("vision") else None
    got = t_replay.render_trajectory(
        types.SimpleNamespace(model=bridge.model_from_numpy(arrays, "cpu")), traj, W, H, name,
        backend="raycast")
    want = j_replay._render_trajectory_raycast(
        types.SimpleNamespace(model=jax_model_from_numpy(arrays)), traj, W, H, name)
    assert got.shape == (3, H, W, 3) and got.dtype == np.uint8
    assert_images_close(got, np.asarray(want), camera)
    assert (got.reshape(3, -1).std(-1) > 0).all(), "a frame of one colour"


def test_mj_model_for_and_auto_backend():
    """MuJoCo 3's model of a world compiled by the port, from its stashed
    source XML (actuators scrubbed), where `mujoco` imports; the "auto"
    backend renders it, through GL or, where no GL context comes up, the
    raycaster."""
    mujoco = pytest.importorskip("mujoco")
    env = types.SimpleNamespace(model=t_compiler.compile_xml(PRIMITIVES, device="cpu"))
    mj_model = t_replay._mj_model_for(env)
    assert (mj_model.nq, mj_model.ngeom, mj_model.nu) == (env.model.const.nq, 3, 0)
    mj_data = mujoco.MjData(mj_model)
    mujoco.mj_forward(mj_model, mj_data)
    traj = np.stack([np.asarray(env.model.qpos0)] * 2)
    frames = t_replay.render_trajectory(env, traj, width=W, height=H)
    assert frames.shape == (2, H, W, 3) and frames.dtype == np.uint8 and frames.max() > 0
    with pytest.raises(ValueError):
        t_replay.render_trajectory(env, traj, backend="opengl")


# ---------------------------------------------------------------------------
# the curses viewer's key handlers
# ---------------------------------------------------------------------------

class _PortStub:
    """A batch-of-one env stand-in: what the viewer's handlers touch."""

    def __init__(self, action_size):
        self.action_size = action_size
        self.dtype, self.device = torch.float32, torch.device("cpu")
        self.generator = torch.Generator()
        self.seeds = []

    def reset(self, batch):
        self.seeds.append(self.generator.initial_seed())
        return None, {}


def _viewers(teleop, seed=3, action_size=6):
    """(port viewer, JAX viewer) on stub envs; the JAX viewer's reset
    records its seeds instead of running a jitted env."""
    port = t_interactive.InteractiveViewer(_PortStub(action_size), seed=seed, teleop=teleop)
    jstub = types.SimpleNamespace(action_size=action_size, seeds=[])
    jv = j_interactive.InteractiveViewer(jstub, seed=seed, teleop=teleop)

    def reset(key):
        jstub.seeds.append(int(jax.random.key_data(key).ravel()[-1]))
        return None, {}

    jv._reset = reset
    return port, jv


@pytest.mark.parametrize("teleop", [False, True])
def test_key_handlers_match_jax(teleop):
    """One key sequence through both viewers' handlers: after each key the
    same return value, action vector, seed and selected dimension, the
    same reset seeds and (teleop) the same controller speeds."""
    import curses

    port, jv = _viewers(teleop)
    if teleop:
        keys = [curses.KEY_UP, curses.KEY_DOWN, curses.KEY_LEFT, curses.KEY_RIGHT] + [
            ord(c) for c in "zxcvweyu=z-x-c-n?"] + [ord("q")]
        handle = ("_handle_teleop_key",)
    else:
        keys = [ord(c) for c in "kkzzzajnppgaz0kkkkkkkzzjjjj"] + [27]
        handle = ("_handle_env_key",)
    for ch in keys:
        got = getattr(port, handle[0])(ch)
        want = getattr(jv, handle[0])(ch)
        assert got == want, ch
        np.testing.assert_array_equal(np.asarray(port.action, np.float64),
                                      np.asarray(jv.action, np.float64), err_msg=str(ch))
        assert (port.seed, port.action_index) == (jv.seed, jv.action_index), ch
        if teleop:
            np.testing.assert_array_equal(port.controller._speeds, jv.controller._speeds)
    assert port.env.seeds == jv.env.seeds and port.env.seeds


def test_interactive_viewer_pty():
    """The port's examine with `interactive=True` on the CPU under a
    pseudo-terminal (as tests/test_tooling.py runs the JAX package's): the
    status pane renders, keys of the env keymap go through, and 'q' ends
    the run with exit code 0."""
    pid, fd = pty.fork()
    if pid == 0:  # the child runs the viewer
        os.environ["TERM"] = "xterm"
        try:
            t_examine.main(["dactyl/locked", "interactive=True", "device=cpu",
                            "constants=@{'mujoco_substeps': 1}"])
            os._exit(0)
        except BaseException:
            os._exit(3)

    out = b""
    deadline = time.time() + 600
    sent = sent_q = False
    t_sent = 0.0
    while time.time() < deadline:
        r, _, _ = select.select([fd], [], [], 1.0)
        if r:
            try:
                out += os.read(fd, 65536)
            except OSError:
                break
        if b"reward" in out and not sent:
            for k in (b"z", b"k", b"a"):
                os.write(fd, k)
                time.sleep(0.3)
            sent, t_sent = True, time.time()
        if sent and not sent_q and time.time() - t_sent > 2:
            os.write(fd, b"q")
            sent_q = True
        if sent_q and time.time() - t_sent > 10:
            break
    if not sent:
        # the env did not come up before the deadline (a contended CPU)
        os.kill(pid, signal.SIGKILL)
        os.close(fd)
        os.waitpid(pid, 0)
        pytest.skip("the viewer did not come up within the deadline")
    os.close(fd)
    _, status = os.waitpid(pid, 0)
    text = out.decode(errors="replace")
    assert os.WIFEXITED(status) and os.WEXITSTATUS(status) == 0, status
    for probe in ("[ENV]", "reward [env goal success]", "selected dim"):
        assert probe in text, probe


# ---------------------------------------------------------------------------
# the scripts
# ---------------------------------------------------------------------------

class _StepStub(_PortStub):
    """A batch-of-one env whose qpos moves by its action: for the teleop
    loop."""

    nq = 3

    def reset(self, batch):
        super().reset(batch)
        self.actions = []
        return self._state(torch.zeros((1, self.nq))), {}

    def _state(self, qpos):
        return types.SimpleNamespace(physics=types.SimpleNamespace(qpos=qpos))

    def step(self, state, action):
        self.actions.append(action.clone())
        qpos = state.physics.qpos + action[:, :self.nq]
        return (self._state(qpos), {}, torch.zeros((1, 3)), torch.zeros(1, dtype=torch.bool), {})


def test_teleop_loop_reads_stdin(monkeypatch, tmp_path, capsys):
    """Typed commands step the env with the controller's actions (an empty
    line with zero control, an unknown command with none), 'q' ends the
    loop, and the record holds the reset state and each step's qpos."""
    commands = iter(["up", "", "bogus", "grip+", "q"])
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(commands))
    env = _StepStub(5)
    path = str(tmp_path / "teleop.npz")
    t_examine._teleop_loop(env, 4, path)
    ctl = t_teleop.URGripperArmController(env)
    want = [ctl.action_for("up"), ctl.zero_control(), ctl.action_for("grip+")]
    assert len(env.actions) == 3 and env.seeds == [4]
    for got, w in zip(env.actions, want):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(w, np.float32))
    assert "unknown command 'bogus'" in capsys.readouterr().out
    with np.load(path) as z:
        assert sorted(z.files) == ["qpos"] and z["qpos"].shape == (4, 3)


@pytest.fixture()
def jax_assets():
    """The JAX package reads the stand-in asset tree (its directories are
    fixed at import, so the module's and `MjcfXML`'s are pointed at it)."""
    cls = j_xml.MjcfXML
    saved = j_xml.ASSETS_DIR, j_xml.XML_DIR, cls.meshdir, cls.texturedir
    with tempfile.TemporaryDirectory() as tmp:
        dactyl_assets_like.write_assets(tmp)
        j_xml.ASSETS_DIR, j_xml.XML_DIR = tmp, os.path.join(tmp, "xmls")
        cls.meshdir, cls.texturedir = os.path.join(tmp, "stls"), os.path.join(tmp, "textures")
        try:
            yield tmp
        finally:
            j_xml.ASSETS_DIR, j_xml.XML_DIR, cls.meshdir, cls.texturedir = saved


def test_examine_record_matches_jax(jax_assets, tmp_path, capsys):
    """`examine dactyl/locked.py num_steps=2 record=...` in both packages
    (the port on the CPU and its snapshot world, the JAX package on the
    world it composes from the stand-in tree, both of nq = 38): the same
    npz keys, shapes and dtypes, (T + 1, nq); the port prints a line each
    step and the observation keys."""
    args = ["dactyl/locked.py", "num_steps=2",
            "constants=@{'mujoco_substeps': 2, 'reset_initial_steps': 2, "
            "'n_random_initial_steps': 1}"]
    t_examine.main(args + [f"record={tmp_path / 'port.npz'}", "device=cpu"])
    out = capsys.readouterr().out
    assert "Loaded env LockedEnv (action_size=20)" in out and "observation keys:" in out
    assert out.count("t=") == 2
    j_examine.main(args + [f"record={tmp_path / 'jax.npz'}"])
    with np.load(tmp_path / "port.npz") as got, np.load(tmp_path / "jax.npz") as want:
        assert sorted(got.files) == sorted(want.files) == ["qpos"]
        assert got["qpos"].shape == want["qpos"].shape == (3, 38)
        assert got["qpos"].dtype == want["qpos"].dtype
        assert np.isfinite(got["qpos"]).all()


def test_create_holdout_state_reads_back(tmp_path):
    """`create_holdout` on the stand-in holdout's config (the CPU, one
    settle step) writes `initial_state_<ts>.npz` with `obj_pos` (2, 3) and
    `obj_quat` (2, 4) of its one env; the port's holdout loader and the JAX
    package's (`HoldoutRearrangeEnv.__init__`, its scene left unbuilt) read
    it back equal to what was saved."""
    t_create.main([holdout_ball_like.CONFIG, f"out_dir={tmp_path}", "kind=initial",
                   "settle_steps=1", "device=cpu"])
    (path,) = glob.glob(str(tmp_path / "initial_state_*.npz"))
    with np.load(path) as z:
        saved = {k: z[k] for k in z.files}
    assert sorted(saved) == ["obj_pos", "obj_quat"]
    assert saved["obj_pos"].shape == (2, 3) and saved["obj_quat"].shape == (2, 4)
    assert np.isfinite(saved["obj_pos"]).all()
    np.testing.assert_allclose(np.linalg.norm(saved["obj_quat"], axis=-1), 1.0, atol=1e-5)
    got = t_holdout._load_state(str(tmp_path), os.path.basename(path), 2)

    jenv = object.__new__(j_holdout.HoldoutRearrangeEnv)
    cst = j_holdout.HoldoutEnvConstants(initial_state_path=os.path.basename(path),
                                        goal_state_paths=())
    par = j_blocks.RearrangeEnvParameters()
    orig_init, orig_dir = j_blocks.BlocksRearrangeEnv.__init__, j_holdout.STATE_DIR
    j_blocks.BlocksRearrangeEnv.__init__ = lambda self, *a, **kw: None
    j_holdout.STATE_DIR = str(tmp_path)
    try:
        j_holdout.HoldoutRearrangeEnv.__init__(jenv, cst, par, [{"count": 2}])
    finally:
        j_blocks.BlocksRearrangeEnv.__init__, j_holdout.STATE_DIR = orig_init, orig_dir
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k])
        np.testing.assert_array_equal(jenv._initial_state[k], saved[k])
