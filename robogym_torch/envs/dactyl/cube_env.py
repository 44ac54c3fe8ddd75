"""Shared dactyl cube-env machinery, batched: cube and target index tables,
the palm check, the parallel-quat table and goal sampling, and the reset
randomization (zero-control settle, cube pose wiggle, random warmup steps,
retries until the cube is on the palm).

Counterpart of `robogym_tpu/envs/dactyl/cube_env.py`. Every random
function comes as a draw (from the env's `torch.Generator`: standard
normal or uniform [0, 1) variates, and integers) and an apply that takes
the draws, so that a caller can feed the draws of another generator. The
env takes a compiled Model: a world snapshot through
`robogym_torch.bridge.model_from_numpy`, or the port's own compile of a
world's XML (`robogym_torch.mjcf.compiler.compile_xml`;
`robogym_torch.worlds.compile` for the stand-ins). `compile_world`
composes the dactyl world from robogym's asset XMLs (`build_cube_world_xml`:
hand, cube, target cube, floor and light) and compiles it, as the JAX
constructor does; the assets are read from `xml_tools.ASSETS_DIR`
(`ROBOGYM_TPU_ASSETS`; `robogym_torch/worlds/dactyl_assets_like.py` writes
a stand-in tree).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from robogym_torch.envs import core
from robogym_torch.mjcf.compiler import compile_xml
from robogym_torch.mjcf.model import Data, Model, make_data
from robogym_torch.mjcf.xml_tools import MjcfXML
from robogym_torch.physics import step as physics
from robogym_torch.robot import shadow_hand as hand
from robogym_torch.utils import rotation as rot

# the 24 proper rotations of the cube group, sign-normalised unit quaternions
PARALLEL_QUATS = np.asarray(rot.get_parallel_rotations(), np.float64)


@dataclasses.dataclass(frozen=True)
class DactylCubeEnvConstants(core.EnvConstants):
    """(cube_env.py:57-135)."""

    successes_needed: int = 50
    max_timesteps_per_goal: int = 400
    reset_initial_steps: int = 20
    n_random_initial_steps: int = 10
    max_pose_resets: int = 8
    cube_position_wiggle_std: float = 0.005
    drop_reward: float = -20.0
    stop_on_fall: bool = True
    # phasespace-style relative fingertips (hand_forward_kinematics.py:39-51)
    relative_fingertips: bool = True


REFERENCE_SITE_NAMES = ["phasespace_ref0", "phasespace_ref1", "phasespace_ref2"]


# Three fixed cameras looking at the on-palm cube from above, right and
# left (the JAX package's placements: the reference's vision rig is not in
# the public assets); a camera looks along its local -Z, so zaxis points
# from the cube to the camera.
DACTYL_VISION_CAMERA_XML = """
<mujoco>
  <worldbody>
    <camera name="vision_cam_top" pos="1.0 0.87 0.75" zaxis="0 0 1"
            fovy="45"/>
    <camera name="vision_cam_right" pos="1.4 0.5 0.55"
            zaxis="0.4 -0.37 0.3" fovy="45"/>
    <camera name="vision_cam_left" pos="0.6 0.5 0.55"
            zaxis="-0.4 -0.37 0.3" fovy="45"/>
  </worldbody>
</mujoco>
"""


def build_cube_world_xml(cube_xml_path: str, cube_density: float = 421.0,
                         with_vision_cams: bool = False) -> MjcfXML:
    """The world every cube env composes (cube_env.py:172-218,
    locked.py:79-96): the cube file parsed twice, as the cube `cube:` and
    the collision-free target `target:`, the floor, the hand `robot0:` on
    its mount, the light, and where asked the three vision cameras."""
    xml = MjcfXML()
    xml.add_default_compiler_directive()
    if with_vision_cams:
        xml.append(MjcfXML.from_string(DACTYL_VISION_CAMERA_XML))
    xml.append(
        MjcfXML.parse(cube_xml_path)
        .remove_objects_by_name("annotation:outer_bound")
        .add_name_prefix("cube:")
        .set_named_objects_attr("cube:middle", tag="body", pos=[1.0, 0.87, 0.2])
        .set_named_objects_attr("cube:middle", tag="geom", density=cube_density)
    )
    xml.append(
        MjcfXML.parse(cube_xml_path)
        .remove_objects_by_name("annotation:outer_bound")
        .add_name_prefix("target:")
        .set_named_objects_attr("target:middle", tag="body", pos=[1.0, 0.87, 0.2])
        .set_objects_attr(tag="geom", group="2", conaffinity="0", contype="0")
    )
    xml.append(
        MjcfXML.parse("floor/basic_floor.xml").set_named_objects_attr(
            "floor", tag="body", pos=[1, 1, 0]
        )
    )
    xml.append(hand_xml())
    xml.append(MjcfXML.parse("light/default.xml"))
    return xml


def hand_xml() -> MjcfXML:
    """The Shadow Hand `robot0:` on its mount, its outer bound and base
    removed (as each dactyl world places it)."""
    return (MjcfXML.parse("robot/shadowhand/main.xml")
            .add_name_prefix("robot0:")
            .set_named_objects_attr("robot0:hand_mount", tag="body", pos=[1.0, 1.25, 0.15],
                                    euler=[np.pi / 2, 0, np.pi])
            .remove_objects_by_name("robot0:annotation:outer_bound")
            .remove_objects_by_name("robot0:hand_base"))


@dataclasses.dataclass(frozen=True)
class CubeIndex:
    """Joint and site index tables of the cube and target bodies."""

    cube_pos_qpos: np.ndarray   # (3,) slide joint qpos addresses
    cube_rot_qpos: np.ndarray   # (4,) ball joint quaternion qpos addresses
    cube_pos_dof: np.ndarray    # (3,)
    cube_rot_dof: np.ndarray    # (3,)
    target_pos_qpos: np.ndarray
    target_rot_qpos: np.ndarray
    cube_center_site: int

    @classmethod
    def build(cls, model: Model) -> "CubeIndex":
        c = model.const
        jn = c.names["joint"]

        def qadr(name, n):
            a = int(c.jnt_qposadr[jn[name]])
            return np.arange(a, a + n, dtype=np.int64)

        def dadr(name, n):
            a = int(c.jnt_dofadr[jn[name]])
            return np.arange(a, a + n, dtype=np.int64)

        return cls(
            cube_pos_qpos=np.concatenate([qadr(f"cube:cube_t{ax}", 1) for ax in "xyz"]),
            cube_rot_qpos=qadr("cube:cube_rot", 4),
            cube_pos_dof=np.concatenate([dadr(f"cube:cube_t{ax}", 1) for ax in "xyz"]),
            cube_rot_dof=dadr("cube:cube_rot", 3),
            target_pos_qpos=np.concatenate([qadr(f"target:cube_t{ax}", 1) for ax in "xyz"]),
            target_rot_qpos=qadr("target:cube_rot", 4),
            cube_center_site=int(c.names["site"]["cube:center"]),
        )


def rubik_cube_index(model: Model) -> CubeIndex:
    """The Rubik's cube envs' index tables: the slides `cube:cube:tx/ty/tz`,
    the ball `cube:cube:rot` and the site `cube:center`; no target
    (face_perpendicular.py:139-165, full_perpendicular.py:95-121)."""
    c = model.const
    jn = c.names["joint"]

    def qadr(name, n=1):
        a = int(c.jnt_qposadr[jn[name]])
        return np.arange(a, a + n, dtype=np.int64)

    def dadr(name, n=1):
        a = int(c.jnt_dofadr[jn[name]])
        return np.arange(a, a + n, dtype=np.int64)

    return CubeIndex(
        cube_pos_qpos=np.concatenate([qadr(f"cube:cube:t{ax}") for ax in "xyz"]),
        cube_rot_qpos=qadr("cube:cube:rot", 4),
        cube_pos_dof=np.concatenate([dadr(f"cube:cube:t{ax}") for ax in "xyz"]),
        cube_rot_dof=dadr("cube:cube:rot", 3),
        target_pos_qpos=np.zeros(0, np.int64),
        target_rot_qpos=np.zeros(0, np.int64),
        cube_center_site=int(c.names["site"].get("cube:center", 0)),
    )


def _ix(ids, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=like.device)


def cube_pos(idx: CubeIndex, d: Data) -> torch.Tensor:
    return d.qpos[:, _ix(idx.cube_pos_qpos, d.qpos)]


def cube_quat(idx: CubeIndex, d: Data) -> torch.Tensor:
    return rot.quat_normalize(d.qpos[:, _ix(idx.cube_rot_qpos, d.qpos)])


def is_on_palm(idx: CubeIndex, d: Data) -> torch.Tensor:
    """(B,) the cube:center site above the palm plane (cube_utils.py:18-24)."""
    return d.site_xpos[:, idx.cube_center_site, 2] > 0.04


def up_axis_with_sign(cube_quat: torch.Tensor):
    """The cube-frame axis (index (B,) and sign (B,)) closest to world up
    (cube_utils.py:157-165)."""
    z_dots = rot.quat2mat(cube_quat)[..., 2, :]
    axis_nr = torch.argmax(torch.abs(z_dots), dim=-1)
    sign = torch.sign(torch.gather(z_dots, -1, axis_nr[..., None])[..., 0])
    return axis_nr, torch.where(sign == 0, torch.ones_like(sign), sign)


def _axis(cube_quat, axis_nr, sign):
    mtx = rot.quat2mat(cube_quat)
    col = torch.gather(mtx, -1, axis_nr[..., None, None].expand(mtx.shape[:-1] + (1,)))[..., 0]
    return col * sign[..., None]


def _z_up(like: torch.Tensor) -> torch.Tensor:
    return torch.tensor([0.0, 0.0, 1.0], dtype=like.dtype, device=like.device)


def align_quat_up(cube_quat: torch.Tensor) -> torch.Tensor:
    """Rotate each quat so that its nearest-up face is exactly up
    (cube_utils.py:138-154)."""
    axis_nr, sign = up_axis_with_sign(cube_quat)
    dq = rot.vectors2quat(_axis(cube_quat, axis_nr, sign), _z_up(cube_quat))
    return rot.quat_normalize(rot.quat_mul(dq, cube_quat))


def distance_quat_from_being_up(cube_quat: torch.Tensor, axis_nr: torch.Tensor,
                                sign: torch.Tensor) -> torch.Tensor:
    """The residual quat of the given cube axis from pointing up
    (cube_utils.py:168-181)."""
    return rot.quat_normalize(rot.vectors2quat(_axis(cube_quat, axis_nr, sign),
                                               _z_up(cube_quat)))


def uniform_z_aligned_quat(u: torch.Tensor) -> torch.Tensor:
    """Rotations about z at angles uniform in [-pi, pi) from draws u (B,)
    in [0, 1) (cube_utils.py:26-31)."""
    angle = core.uniform_apply(u, -np.pi, np.pi)
    return rot.quat_normalize(rot.quat_from_angle_and_axis(angle, _z_up(u)))


def draw_parallel_goal(gen: torch.Generator, n: int, dtype=torch.float32, device=None):
    """Draws of `sample_parallel_goal_quat` for n envs: (u (n,) in [0, 1),
    choice (n,) in [0, 24))."""
    u = torch.rand((n,), generator=gen, dtype=dtype, device=device)
    choice = torch.randint(0, len(PARALLEL_QUATS), (n,), generator=gen, device=device)
    return u, choice


def sample_parallel_goal_quat(u: torch.Tensor, choice: torch.Tensor) -> torch.Tensor:
    """LockedParallelGoal.next_goal (goals/locked_parallel.py:32-47) on
    draws: a z-aligned quat times a parallel (cube-group) quat."""
    parallel = torch.as_tensor(PARALLEL_QUATS, dtype=u.dtype, device=u.device)[choice]
    return rot.quat_mul(uniform_z_aligned_quat(u), parallel)


def relative_fingertip_positions(hand_idx: hand.HandIndex, model: Model,
                                 d: Data) -> torch.Tensor:
    """(B, 15) fingertips in the phasespace reference frame
    (hand_forward_kinematics.py:39-51): origin at ref1, basis [ref0_hat,
    ref0_hat x ref2_hat, ref2_hat]."""
    c = model.const
    ref_ids = [c.names["site"][hand_idx.prefix + s] for s in REFERENCE_SITE_NAMES]
    refs = d.site_xpos[:, _ix(ref_ids, d.site_xpos)]                       # (B, 3, 3)
    tips = d.site_xpos[:, _ix(hand_idx.fingertip_site_ids, d.site_xpos)]   # (B, 5, 3)
    origin = refs[:, 1]
    r0 = refs[:, 0] - origin
    r2 = refs[:, 2] - origin
    r0 = r0 / rot.norm(r0, keepdim=True)
    r2 = r2 / rot.norm(r2, keepdim=True)
    mbasis = torch.stack([r0, rot.cross(r0, r2), r2], dim=-1)             # columns
    return ((tips - origin[:, None]) @ mbasis).reshape(d.qpos.shape[0], -1)


def data_take(d: Data, idx: torch.Tensor) -> Data:
    """The states of envs `idx`."""
    return core.data_map(lambda x: x[idx], d)


def data_put(d: Data, idx: torch.Tensor, sub: Data) -> Data:
    """`d` with envs `idx` replaced by `sub`'s."""
    return core.data_map(lambda x, y: x.index_copy(0, idx, y.to(x.dtype)), d, sub)


class CubeEnvBase:
    """Construction and reset randomization shared by the dactyl cube envs.

    `model` is the compiled world (with the hand names of `HandIndex`, and
    the cube and target names that `build_cube_index` binds), on the
    device the env runs on. The zero-control settle of
    `reset_initial_steps x mujoco_substeps` substeps does not depend on any
    draw, so it runs once here."""

    CUBE_XML: str = "rubik/rubik_locked.xml"

    def __init__(self, constants: DactylCubeEnvConstants, model: Model, seed: int = 0):
        self.constants = constants
        dev, dtype = model.device, model.dtype
        model = model.replace(opt=dataclasses.replace(
            model.opt, timestep=torch.tensor(constants.mujoco_timestep, dtype=dtype, device=dev)))
        self.model = model
        self.hand = hand.HandIndex.build(model)
        self.cube = self.build_cube_index(model)
        self.action_size = 20
        self.generator = torch.Generator(device=dev)
        self.generator.manual_seed(seed)
        self.reset_retries = 0

        d0 = make_data(model, 1)
        ctrl0 = hand.denormalize_position_control(self.hand, model, d0,
                                                  hand.zero_control(1, dtype, dev),
                                                  relative_action=False)
        d0 = physics.step_n(model, d0.replace(ctrl=ctrl0),
                            constants.reset_initial_steps * constants.mujoco_substeps)
        self._settled_data = d0.replace(time=torch.zeros_like(d0.time))

    def build_cube_index(self, model: Model) -> CubeIndex:
        """The cube's index tables on `model`, bound before the settle: the
        locked world's names here; an env on a world with other names
        overrides it."""
        return CubeIndex.build(model)

    @property
    def device(self) -> torch.device:
        return self.model.device

    @property
    def dtype(self) -> torch.dtype:
        return self.model.dtype

    # ------------------------------------------------------------------
    def draw_attempt(self, n: int) -> Dict[str, torch.Tensor]:
        """The draws of one reset attempt for n envs: the cube position's
        wiggle (n, 3) standard normal, its orientation (n, 3) and the
        warmup action (n, 20) uniform in [0, 1)."""
        g, dev, dt = self.generator, self.device, self.dtype
        return dict(wiggle=torch.randn((n, 3), generator=g, dtype=dt, device=dev),
                    quat=torch.rand((n, 3), generator=g, dtype=dt, device=dev),
                    action=torch.rand((n, self.action_size), generator=g, dtype=dt, device=dev))

    def _randomize_cube_pose(self, d: Data, wiggle: torch.Tensor, quat_u: torch.Tensor) -> Data:
        """Wiggle the cube's position, and a uniform orientation
        (locked.py:207-217)."""
        qpos = d.qpos.clone()
        pos = _ix(self.cube.cube_pos_qpos, qpos)
        qpos[:, pos] = qpos[:, pos] + self.constants.cube_position_wiggle_std * wiggle
        qpos[:, _ix(self.cube.cube_rot_qpos, qpos)] = rot.uniform_quat_apply(quat_u).to(qpos.dtype)
        return d.replace(qpos=qpos)

    def _random_warmup_steps(self, d: Data, action_u: torch.Tensor) -> Data:
        """n_random_initial_steps with one random action each env
        (locked.py:218-225)."""
        cst = self.constants
        if cst.n_random_initial_steps <= 0:
            return physics.fwd_position(self.model, d)
        action = core.uniform_apply(action_u, -1.0, 1.0)
        ctrl = hand.denormalize_position_control(self.hand, self.model, d, action,
                                                 relative_action=False)
        return physics.step_n(self.model, d.replace(ctrl=ctrl),
                              cst.n_random_initial_steps * cst.mujoco_substeps)

    def _attempt(self, base: Data, draws: Dict[str, torch.Tensor]) -> Data:
        d = self._randomize_cube_pose(base, draws["wiggle"], draws["quat"])
        return self._random_warmup_steps(d, draws["action"])

    def reset_physics(self, batch: int,
                      attempts: Optional[List[Dict[str, torch.Tensor]]] = None,
                      initial: Optional[Data] = None) -> Data:
        """Pose randomization for `batch` envs, retried on the envs whose
        cube is not on the palm, up to `max_pose_resets` times
        (cube_env.py:330-355). Each retry runs only those envs, from their
        start: `initial` (`batch` envs, as the full env's scramble leaves
        them) or else the settled state. `attempts[i]`, if given, holds
        attempt i's draws for every env (`draw_attempt(batch)`), else they
        come from the env's generator. Sets `reset_retries` to the retries
        run."""
        base = initial if initial is not None else core.data_map(
            lambda x: x.expand((batch,) + x.shape[1:]).clone(), self._settled_data)
        d = self._attempt(base, attempts[0] if attempts else self.draw_attempt(batch))
        self.reset_retries = 0
        for i in range(self.constants.max_pose_resets):
            idx = torch.nonzero(~is_on_palm(self.cube, d)).flatten()
            if idx.numel() == 0:
                break
            draws = ({k: v[idx] for k, v in attempts[i + 1].items()} if attempts
                     else self.draw_attempt(int(idx.numel())))
            d = data_put(d, idx, self._attempt(data_take(base, idx), draws))
            self.reset_retries += 1
        return d


def compile_world(constants, device="cuda", cube_xml: str = CubeEnvBase.CUBE_XML,
                  build_world_xml=build_cube_world_xml) -> Model:
    """The cube env's world composed from the assets by `build_world_xml`
    and compiled on `device` (the card unless the caller asks for the CPU),
    as the JAX constructor compiles it (cube_env.py:252-262), with the
    vision cameras where `constants` render images ("raycast"). The env
    sets its timestep from `constants` at construction."""
    cams = getattr(constants, "vision_observation_provider", "") == "raycast"
    return compile_xml(build_world_xml(cube_xml, with_vision_cams=cams), device=device)
