"""The rearrange simulation layer, batched: the world's index tables
(objects, table, gripper geoms), the placement area, object state access,
and the contact readings the env observes and rewards.

Counterpart of `robogym_tpu/envs/rearrange/simulation.py`, with the
world's composition (`make_block_xml`, `build_blocks_world_xml`,
`compile_blocks_world`, `compile_solver_world`, `scale_contact_budgets`,
`build_settle_world_xml`) on the host. Every state tensor carries
a leading env axis `(B, ...)`; the active-object mask is `(O,)`, shared by
the batch (`num_objects` is a constant of the env).
"""

from __future__ import annotations

import dataclasses
import xml.etree.ElementTree as et
from typing import Optional, Tuple

import numpy as np
import torch

from robogym_torch.mjcf.compiler import compile_xml
from robogym_torch.mjcf.model import Data, GeomType, Model
from robogym_torch.mjcf.xml_tools import MjcfXML
from robogym_torch.utils import rotation as rot

# unused object slots rest on the floor here, far from the table
PARK_POSITION = np.array([2.5, 2.5, 0.05])


@dataclasses.dataclass(frozen=True)
class PlacementArea:
    """(common/utils.py:29-35)."""

    offset: Tuple[float, float, float]
    size: Tuple[float, float, float]


@dataclasses.dataclass(frozen=True)
class RearrangeIndex:
    """Static tables of the compiled rearrange world."""

    max_num_objects: int
    object_body_ids: np.ndarray      # (O,)
    object_geom_ids: np.ndarray      # (O,)
    object_qpos_adr: np.ndarray      # (O,) start of each free joint's 7 qpos
    object_dof_adr: np.ndarray       # (O,) start of its 6 dofs
    table_geom_id: int
    table_body_id: int
    gripper_geom_ids: np.ndarray
    left_finger_geom_ids: np.ndarray
    right_finger_geom_ids: np.ndarray
    table_pos: np.ndarray            # (3,)
    table_size: np.ndarray           # (3,) half sizes

    GRIPPER_BODIES = (
        "robot0:gripper_base", "left_gripper", "left_inner_follower",
        "left_outer_driver", "right_gripper", "right_inner_follower",
        "right_outer_driver",
    )
    LEFT_FINGER_BODIES = ("left_gripper", "left_inner_follower", "left_outer_driver")
    RIGHT_FINGER_BODIES = ("right_gripper", "right_inner_follower", "right_outer_driver")

    @classmethod
    def build(cls, model: Model, max_num_objects: int) -> "RearrangeIndex":
        c = model.const
        bn, gn, jn = c.names["body"], c.names["geom"], c.names["joint"]
        geom_bodyid = np.asarray(c.geom_bodyid)
        joints = [jn[f"object{i}:joint"] for i in range(max_num_objects)]

        def geoms_of(bodies):
            return np.asarray(sorted(int(g) for b in bodies if b in bn
                                     for g in np.nonzero(geom_bodyid == bn[b])[0]), np.int64)

        tgid, tbid = gn["table"], bn["table"]
        return cls(
            max_num_objects=max_num_objects,
            object_body_ids=np.asarray([bn[f"object{i}"] for i in range(max_num_objects)],
                                       np.int64),
            object_geom_ids=np.asarray([gn[f"object{i}"] for i in range(max_num_objects)],
                                       np.int64),
            object_qpos_adr=np.asarray([c.jnt_qposadr[j] for j in joints], np.int64),
            object_dof_adr=np.asarray([c.jnt_dofadr[j] for j in joints], np.int64),
            table_geom_id=int(tgid), table_body_id=int(tbid),
            gripper_geom_ids=geoms_of(cls.GRIPPER_BODIES),
            left_finger_geom_ids=geoms_of(cls.LEFT_FINGER_BODIES),
            right_finger_geom_ids=geoms_of(cls.RIGHT_FINGER_BODIES),
            table_pos=model.body_pos[tbid].detach().cpu().numpy().copy(),
            table_size=model.geom_size[tgid].detach().cpu().numpy().copy(),
        )

    def table_dimensions(self):
        """(simulation/base.py:905-930): (pos, half-size, height)."""
        return self.table_pos, self.table_size, self.table_size[-1] + self.table_pos[-1]

    def placement_area(self, num_objects: int, used_table_portion: float = 1.0) -> PlacementArea:
        """(simulation/base.py:981-1010)."""
        _, table_size, _ = self.table_dimensions()
        table_size_x, table_size_y = table_size[:2] * 2
        used = float(np.clip(used_table_portion, num_objects * 0.1, 1.0))
        place_size_x = 0.5 * table_size_x * used
        place_size_y = 0.38 * table_size_y * used
        return PlacementArea(
            offset=(0.5 * table_size_x - place_size_x / 2.0,
                    0.44 * table_size_y - place_size_y / 2.0, 2 * table_size[2]),
            size=(place_size_x, place_size_y, 0.26))

    def placement_bounds(self, num_objects: int, used_table_portion: float = 1.0):
        """World-frame (min_xyz, max_xyz) of the placement area
        (simulation/base.py:834-845)."""
        table_pos, table_size, _ = self.table_dimensions()
        area = self.placement_area(num_objects, used_table_portion)
        size = np.asarray(area.size) / 2
        pos = np.asarray(area.offset) + table_pos - table_size + size
        return pos - size, pos + size


def _ix(ids, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=like.device)


def _cols(adr: np.ndarray, width: int, like: torch.Tensor) -> torch.Tensor:
    return _ix(adr[:, None] + np.arange(width), like)


def object_positions(idx: RearrangeIndex, d: Data) -> torch.Tensor:
    """(B, O, 3) the objects' free-joint positions."""
    return d.qpos[:, _cols(idx.object_qpos_adr, 3, d.qpos)]


def object_quats(idx: RearrangeIndex, d: Data) -> torch.Tensor:
    return d.qpos[:, _cols(idx.object_qpos_adr + 3, 4, d.qpos)]


def object_velocities(idx: RearrangeIndex, d: Data) -> torch.Tensor:
    """(B, O, 6) the objects' free-joint velocities (angular, linear)."""
    return d.qvel[:, _cols(idx.object_dof_adr, 6, d.qvel)]


def set_object_poses(idx: RearrangeIndex, d: Data, pos: torch.Tensor,
                     quat: torch.Tensor) -> Data:
    """Positions (B, O, 3) and quats (B, O, 4) written into qpos; the
    objects' velocities zeroed."""
    qpos, qvel = d.qpos.clone(), d.qvel.clone()
    qpos[:, _cols(idx.object_qpos_adr, 3, qpos)] = pos.to(qpos.dtype)
    qpos[:, _cols(idx.object_qpos_adr + 3, 4, qpos)] = quat.to(qpos.dtype)
    qvel[:, _cols(idx.object_dof_adr, 6, qvel)] = 0.0
    return d.replace(qpos=qpos, qvel=qvel)


def check_objects_off_table(idx: RearrangeIndex, pos: torch.Tensor, margin: float = 0.1,
                            active_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, O) outside the table's xy extent less `margin`, or more than
    0.1 m below its top (simulation/base.py check_objects_off_table)."""
    table_pos, table_size, table_height = idx.table_dimensions()
    lo = torch.as_tensor(table_pos[:2] - table_size[:2] + margin, dtype=pos.dtype,
                         device=pos.device)
    hi = torch.as_tensor(table_pos[:2] + table_size[:2] - margin, dtype=pos.dtype,
                         device=pos.device)
    off = ((pos[..., 0] < lo[0]) | (pos[..., 0] > hi[0]) | (pos[..., 1] < lo[1])
           | (pos[..., 1] > hi[1]) | (pos[..., 2] < table_height - 0.1))
    return off & active_mask if active_mask is not None else off


def in_placement_area(idx: RearrangeIndex, pos: torch.Tensor, num_objects: int,
                      used_table_portion: float = 1.0, margin: float = 0.02,
                      active_mask: Optional[torch.Tensor] = None, soft: bool = False,
                      u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(B, O) within the placement area (simulation/base.py:847-902),
    `margin` the tolerance outside its boundary; inactive slots report
    True. With `soft`, an object in the margin band is inside where the
    env's one uniform draw `u` (B,) exceeds its distance over the margin
    (the reference's scalar draw, shared by the objects)."""
    lo, hi = idx.placement_bounds(num_objects, used_table_portion)
    lo = torch.as_tensor(lo, dtype=pos.dtype, device=pos.device)
    hi = torch.as_tensor(hi, dtype=pos.dtype, device=pos.device)
    dist = torch.clamp(torch.maximum(pos - hi, lo - pos), min=0.0)
    max_dist = dist.amax(-1)
    if soft:
        if u is None:
            raise ValueError("the soft placement mask takes a uniform draw per env (u)")
        inside = u[:, None] > torch.clamp(max_dist / margin, 0.0, 1.0)
    else:
        inside = max_dist < margin
    return inside | ~active_mask if active_mask is not None else inside


def _isin(x: torch.Tensor, ids: np.ndarray) -> torch.Tensor:
    return torch.isin(x, _ix(ids, x).to(x.dtype))


def gripper_table_contact(idx: RearrangeIndex, m: Model, d: Data) -> torch.Tensor:
    """(B,) any active gripper-geom contact with the table
    (ur16e/mujoco/simulation/base.py:142-167)."""
    con = d.contact
    is_table = (con.geom1 == idx.table_geom_id) | (con.geom2 == idx.table_geom_id)
    grip = _isin(con.geom1, idx.gripper_geom_ids) | _isin(con.geom2, idx.gripper_geom_ids)
    return (con.active & is_table & grip).any(-1)


def geom_bbox_half(m: Model, gids: np.ndarray) -> torch.Tensor:
    """Bounding half-extents of geoms `gids` by type: (O, 3), or (B, O, 3)
    where geom sizes are each env's own (a box's size, a sphere's (r, r,
    r), a cylinder's (r, r, h), a capsule's (r, r, h + r))."""
    t = np.asarray(m.const.geom_type)[np.asarray(gids)]
    s = m.take("geom_size", _ix(gids, m.geom_size))
    r, hh = s[..., :1], s[..., 1:2]
    shapes = {GeomType.SPHERE: torch.cat([r, r, r], -1),
              GeomType.CYLINDER: torch.cat([r, r, hh], -1),
              GeomType.CAPSULE: torch.cat([r, r, hh + r], -1)}
    out = s
    for gt, v in shapes.items():
        out = torch.where(torch.as_tensor(t == gt, device=s.device)[:, None], v, out)
    return out


def contact_wrench_on_geoms(geom_ids: np.ndarray, ref_point: torch.Tensor, m: Model,
                            d: Data) -> Tuple[torch.Tensor, torch.Tensor]:
    """The contact wrench (force (B, 3), torque (B, 3) about `ref_point`
    (B, 3)) on a set of geoms, from each contact's normal force
    `efc_force_contact` (the sum of its facet forces); a normal points from
    geom1 into geom2, so the force on the set flips where its geom is
    geom1 (joint_controlled_arm.py:79-85 reads the wrist sensor)."""
    con = d.contact
    in1, in2 = _isin(con.geom1, geom_ids), _isin(con.geom2, geom_ids)
    sign = in2.to(ref_point.dtype) - in1.to(ref_point.dtype)
    f = d.efc_force_contact * sign * con.active.to(ref_point.dtype)
    F = f[..., None] * con.normal
    T = rot.cross(con.pos - ref_point[:, None, :], F)
    return F.sum(1), T.sum(1)


def object_gripper_contact(idx: RearrangeIndex, d: Data) -> torch.Tensor:
    """(B, O, 2) each object in active contact with the left, the right
    finger (simulation/base.py:548-635)."""
    con = d.contact
    obj = _ix(idx.object_geom_ids, con.geom1).to(con.geom1.dtype)
    is_obj1 = con.geom1[:, None, :] == obj[None, :, None]
    is_obj2 = con.geom2[:, None, :] == obj[None, :, None]
    out = []
    for fingers in (idx.left_finger_geom_ids, idx.right_finger_geom_ids):
        is_f1 = _isin(con.geom1, fingers)[:, None, :]
        is_f2 = _isin(con.geom2, fingers)[:, None, :]
        touch = con.active[:, None, :] & ((is_obj1 & is_f2) | (is_obj2 & is_f1))
        out.append(touch.any(-1))
    return torch.stack(out, dim=-1)


def goal_qpos(idx: RearrangeIndex, d: Data, goal_pos: torch.Tensor,
              goal_quat: torch.Tensor) -> torch.Tensor:
    """(B, nq) qpos with the objects at their goal poses: the
    `qpos_goal` observation (common/base.py:399-404)."""
    qpos = d.qpos.clone()
    qpos[:, _cols(idx.object_qpos_adr, 3, qpos)] = goal_pos.to(qpos.dtype)
    qpos[:, _cols(idx.object_qpos_adr + 3, 4, qpos)] = goal_quat.to(qpos.dtype)
    return qpos


# -- world composition (host) ------------------------------------------------

def make_block_xml(name: str, size) -> MjcfXML:
    """One free box object slot (common/utils.py:195-216 make_block)."""
    size = np.asarray(size, np.float64)
    if size.size == 1:
        size = np.tile(size, 3)
    src = f"""
    <mujoco>
      <worldbody>
        <body name="{name}" pos="0.0 0.0 0.0">
          <geom name="{name}" type="box" rgba="0.8 0.4 0.1 1.0"
                size="{size[0]} {size[1]} {size[2]}" density="1000"/>
          <joint name="{name}:joint" type="free"/>
        </body>
      </worldbody>
    </mujoco>
    """
    return MjcfXML.from_string(src)


def build_blocks_world_xml(max_num_objects: int, block_size: float = 0.0254,
                           robot_control_params=None, mujoco_timestep: float = 0.001) -> MjcfXML:
    """The UR16e world with `max_num_objects` blocks
    (ur16e/mujoco/simulation/base.py:62-115, simulation/base.py:281-306),
    composed from robogym's assets under `xml_tools.XML_DIR`."""
    from robogym_torch.robot.composite import RobotControlParameters

    params = robot_control_params or RobotControlParameters()
    xml = (MjcfXML.parse("robot/ur16e/base.xml")
           .set_objects_attr(tag="option", timestep=mujoco_timestep)
           .add_default_compiler_directive())
    if params.is_joint_actuated():
        xml.remove_objects_by_name("mocap_weld")
        sub = params.arm_joint_calibration_path
        xml.append(MjcfXML.parse(f"robot/ur16e/jointspec/calibrations/{sub}/ur16e_ik_class.xml"))
        xml.append(MjcfXML.parse(
            f"robot/ur16e/jointspec/calibrations/{sub}/joint_actuations.xml"))
    else:
        xml.append(MjcfXML.parse("robot/ur16e/jointspec/ur16e_mocap_class.xml"))
    xml.append(MjcfXML.parse("robot/ur16e/gripper_actuators.xml"))
    for i in range(max_num_objects):
        xml.append(make_block_xml(f"object{i}", block_size))
    return xml


def compile_blocks_world(max_num_objects: int, block_size: float = 0.0254,
                         robot_control_params=None, mujoco_timestep: float = 0.001,
                         dtype=torch.float32, device="cuda",
                         build_world_xml=build_blocks_world_xml
                         ) -> Tuple[Model, RearrangeIndex]:
    """The compiled blocks world on `device` and its index; the world's XML
    from `build_world_xml` (`build_blocks_world_xml`'s signature)."""
    xml = build_world_xml(max_num_objects, block_size, robot_control_params, mujoco_timestep)
    model = compile_xml(xml, dtype=dtype, device=device)
    return model, RearrangeIndex.build(model, max_num_objects)


def compile_solver_world(robot_control_params, mujoco_timestep: float = 0.001,
                         dtype=torch.float32, device="cuda",
                         build_world_xml=build_blocks_world_xml) -> Model:
    """The mocap_ik solver simulation: the same arm, gripper and table in
    mocap mode with no task objects, the second sim of robogym's dual-sim
    TCP control (ur_gripper_arm.py:146-160 build_solver_sim); it shares
    the main sim's timestep and substeps."""
    solver_params = dataclasses.replace(robot_control_params, tcp_solver_mode="mocap")
    xml = build_world_xml(0, robot_control_params=solver_params,
                          mujoco_timestep=mujoco_timestep)
    return compile_xml(xml, dtype=dtype, device=device)


def scale_contact_budgets(model: Model, n_objects: int, n_extra_bodies: int = 0) -> Model:
    """Raise the static contact budgets for dense multi-object scenes.

    The Option defaults (ncon_active=32, group_cap=48) are tuned for the
    dactyl hand worlds; a scene with O resting objects needs about 4 rows
    per object-table manifold plus object-object stacks (the static-shape
    analogue of robogym's per-env nconmax sizing, cube_env.py:229-243).
    Returns `model` unchanged when the defaults already suffice."""
    n = n_objects + n_extra_bodies
    ncon = max(model.opt.ncon_active, ((16 + 5 * n + 7) // 8) * 8)
    cap = max(model.opt.group_cap, ((32 + 4 * n + 7) // 8) * 8)
    if (ncon, cap) == (model.opt.ncon_active, model.opt.group_cap):
        return model
    return model.replace(opt=dataclasses.replace(model.opt, ncon_active=ncon, group_cap=cap))


def build_settle_world_xml(world_xml_string: str) -> MjcfXML:
    """Objects-only copy of a composed rearrange world for the goal settle:
    every `robot0:`-prefixed body, the backdrop and the mocap bodies,
    actuators, tendons, equalities, sensors and contact sections removed;
    the floor, table and objects kept. Objects falling onto the table need
    no arm dofs, arm pairs or actuation, so the settle runs on this small
    world (robogym steps the full sim on the host where a goal is
    resampled, goals/object_state.py:292-330)."""
    root = et.fromstring(world_xml_string)

    def is_robot_body(el) -> bool:
        name = el.get("name", "")
        return (name.startswith("robot0:") or name == "backdrop"
                or el.get("mocap", "false") == "true")

    def scrub(parent):
        for child in list(parent):
            if child.tag in ("actuator", "tendon", "equality", "sensor", "contact"):
                parent.remove(child)
            elif child.tag == "body" and is_robot_body(child):
                parent.remove(child)
            else:
                scrub(child)

    scrub(root)
    return MjcfXML.from_string(et.tostring(root, encoding="unicode"))
