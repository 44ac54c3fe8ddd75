"""A UR16e-and-table world with the names rearrange/blocks binds to.

The UR16e, Robotiq 2f-85 and table assets are not part of this repository,
so this module writes a stand-in that both packages' env code binds to
(`robogym_tpu/robot/ur16e.py:21-73`, `robogym_tpu/robot/gripper.py:23-43`,
`robogym_tpu/envs/rearrange/simulation.py:108-163`):

  * a six-hinge arm `robot0:J1..J6` with the UR16e's link offsets, each
    link a convex hull (an octagonal prism written as ASCII STL beside the
    MJCF), on a base beside the table;
  * in the joint-actuated world (`joint_actuated=True`, the main sim of
    the default mocap_ik control) the six cascaded-PI actuators
    `ur_actuator_1..6` (`<general>`, unprefixed as `ur16e.ACTUATORS` names them, gaintype and biastype "user",
    user="1", as the UR16e's calibration drives them); in the mocap world
    (the solver sim) the equality `mocap_weld` between `robot0:mocap` and
    `robot0:gripper_tcp` instead;
  * a two-finger gripper under the 2f-85's body names: `robot0:gripper_base`
    and, on each side, an outer driver (the right one on
    `robot0:r_gripper_RJ0_outer`, which the position actuator
    `robot0:r_gripper_finger_joint` drives), an inner follower and the
    finger (`left_gripper`, `right_gripper`). Each finger's four-bar is a
    parallelogram closed by a `connect` equality (follower tip to the
    finger's origin); a `joint` equality makes the left driver follow the
    right one. Both driver joints are limited to [0, 0.8] rad;
  * the mocap body `robot0:mocap` and the body `robot0:gripper_tcp`
    between the fingers (no geom), in both worlds;
  * a box `table` body and geom, a floor plane, and `max_num_objects`
    boxes `object{i}` on free joints `object{i}:joint`
    (`make_block_xml`'s boxes: half-size `block_size`, density 1000).

Pairs: block-block and block-table are box-box (kernel E); the table and
the blocks against arm and gripper hulls are box-mesh (kernel C); the two
fingers against each other are mesh-mesh (kernel D); the floor against the
blocks parked on it (`PARK_POSITION`) and against the hulls are plane
pairs. The arm's links do not collide with each other, nor the gripper's
links with each other or with the wrist, but for the two fingers.

The JAX package's equality semantics hold (its compiler leaves a
`connect`'s body-2 anchor at zero and a `weld` without `relpose` at the
identity), so each `connect` anchors at the finger's origin.

Pure Python and numpy: `write(directory, ...)` writes the STL files and
returns the MJCF text. The compiled models ship next to this file (see
`tools/build_locked_like_snapshot.py`): `rearrange_blocks_like.npz`, the
main world at 8 objects with the contact budgets `scale_contact_budgets(
model, 8)` gives it; `rearrange_solver_like.npz`, the mocap world with
no objects; `rearrange_settle_like.npz`, the objects-only goal-settle world
(the main world without the arm, the mocap body, actuators and equalities:
floor, table and 8 blocks, nv = 48) with the default contact budgets;
`rearrange_dominos_like.npz`, the main world with 8 blocks of half-size
`BLOCK_HALF * DOMINO_PROPORTIONS`; and `rearrange_wordblocks_like.npz`, the
main world at 6 blocks.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from robogym_torch.worlds import locked_like

PREFIX = "robot0:"
MAX_NUM_OBJECTS = 8
BLOCK_HALF = 0.0254
TABLE_HALF = (0.5, 0.6, 0.2)
TABLE_POS = (0.0, 0.0, 0.2)
# the arm's base, on a pedestal beside the table's -x edge, and its yaw
BASE_POS = (-0.6105643935881153, -0.072, 0.31)
BASE_YAW = 1.2230293389378815
_HERE = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(_HERE, "rearrange_blocks_like.npz")
SOLVER_SNAPSHOT = os.path.join(_HERE, "rearrange_solver_like.npz")
SETTLE_SNAPSHOT = os.path.join(_HERE, "rearrange_settle_like.npz")
DOMINOS_SNAPSHOT = os.path.join(_HERE, "rearrange_dominos_like.npz")
WORDBLOCKS_SNAPSHOT = os.path.join(_HERE, "rearrange_wordblocks_like.npz")
# dominos' half-sizes relative to a block's (simulation/dominos.py:35-40)
DOMINO_PROPORTIONS = np.array([0.2, 1.0, 2.0])
WORDBLOCKS_OBJECTS = 6

# (body, parent, pos in parent, quat in parent, joint, hull axis, length, radius,
#  armature, cascaded-PI gains "Kp Ti iClamp _ _ Kvp Tiv iClamp_v ema max_vel")
_ROT_Y = "0.7071067811865476 0 0.7071067811865476 0"
_BIG = "10 0 0 0 0 300 0.1 0.2 0 2"
_SMALL = "10 0 0 0 0 30 0.1 0.2 0 2"
_ARM = (
    ("shoulder_link", "base_link", (0, 0, 0.181), None, "J1", "y", 0.176, 0.07, 0.5, _BIG),
    ("upper_arm_link", "shoulder_link", (0, 0.176, 0), _ROT_Y, "J2", "z", 0.478, 0.06, 0.5, _BIG),
    ("forearm_link", "upper_arm_link", (0, -0.137, 0.478), None, "J3", "z", 0.36, 0.05, 0.5, _BIG),
    ("wrist_1_link", "forearm_link", (0, 0, 0.36), _ROT_Y, "J4", "y", 0.135, 0.045, 0.1, _SMALL),
    ("wrist_2_link", "wrist_1_link", (0, 0.135, 0), None, "J5", "z", 0.12, 0.045, 0.1, _SMALL),
    ("wrist_3_link", "wrist_2_link", (0, 0, 0.12), None, "J6", "y", 0.117, 0.04, 0.1, _SMALL),
)
_JOINT_AXIS = {"J1": "0 0 1", "J2": "0 1 0", "J3": "0 1 0", "J4": "0 1 0", "J5": "0 0 1",
               "J6": "0 1 0"}
# Each joint's zero offset: at the tabletop experiment's initial joint
# positions (`robogym_tpu/robot/ur16e.py:30`) the stand-in's links take the
# UR16e's pose at (-90, -90, 90, -90, -90, 0) degrees, the gripper down
_TABLETOP = np.deg2rad([135.0, -90.0, 135.0, -100.0, -240.0, 135.0])
_ZERO_OFFSET = {f"J{i + 1}": float(a - b) for i, (a, b) in enumerate(
    zip(np.deg2rad([-90.0, -90.0, 90.0, -90.0, -90.0, 0.0]), _TABLETOP))}
# the gripper, in its base's frame (z out of the flange, fingers closing
# along x): driver pivot A, follower pivot C, links of length L along z
_A_X, _C_X, _PIVOT_Z, _C_Z, _LINK = 0.03, 0.012, 0.06, 0.07, 0.05
TCP_Z = 0.16
DRIVER_RANGE = (0.0, 0.8)


def _hull(length: float, radius: float, axis: str) -> np.ndarray:
    """`locked_like._prism` along x, y or z (32 verts)."""
    pts = locked_like._prism(length, radius, "x")
    perm = {"x": [0, 1, 2], "y": [1, 0, 2], "z": [1, 2, 0]}[axis]
    out = np.zeros_like(pts)
    out[:, perm] = pts
    return out


def _box_hull(half) -> np.ndarray:
    """The 8 corners of a box of half-sizes `half`, as a hull (z from 0)."""
    hx, hy, hz = half
    return np.asarray([(sx * hx, sy * hy, hz + sz * hz)
                       for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)])


def _qmul(a, b):
    w0, x0, y0, z0 = a
    w1, x1, y1, z1 = b
    return np.array([w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1, w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1,
                     w0 * y1 + y0 * w1 + z0 * x1 - x0 * z1, w0 * z1 + z0 * w1 + x0 * y1 - y0 * x1])


def _body_quat(quat, joint: str) -> str:
    """A link's frame: its UR16e frame turned about its joint's axis by the
    joint's zero offset (`_ZERO_OFFSET`)."""
    axis = np.asarray([float(x) for x in _JOINT_AXIS[joint].split()])
    half = 0.5 * _ZERO_OFFSET[joint]
    turn = np.concatenate([[np.cos(half)], np.sin(half) * axis])
    base = np.asarray([float(x) for x in quat.split()]) if quat else np.array([1.0, 0, 0, 0])
    q = _qmul(base, turn)
    return ' quat="' + " ".join(repr(float(x)) for x in q) + '"'


def _yaw_quat(yaw: float) -> str:
    return f"{float(np.cos(yaw / 2))!r} 0 0 {float(np.sin(yaw / 2))!r}"


def write(directory: str, max_num_objects: int = MAX_NUM_OBJECTS,
          block_size: float = BLOCK_HALF, joint_actuated: bool = True,
          timestep: float = 0.001) -> str:
    """Write the link hulls as ASCII STL into `directory` and return the
    MJCF text (mesh paths are absolute): the joint-actuated world, or with
    `joint_actuated=False` the mocap world, with `max_num_objects` blocks
    of half-size `block_size`."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    P = PREFIX
    assets: List[str] = []

    def mesh(name, verts):
        with open(os.path.join(directory, f"{name}.stl"), "w") as f:
            f.write(locked_like._stl(verts))
        assets.append(f'    <mesh name="{P}{name}" file="{name}.stl"/>')
        return f'<geom name="{P}{name}" type="mesh" mesh="{P}{name}" density="1000"/>'

    # arm: nested bodies
    arm = [f'    <body name="{P}base_link" pos="{BASE_POS[0]} {BASE_POS[1]} {BASE_POS[2]}" '
           f'quat="{_yaw_quat(BASE_YAW)}">',
           "      " + mesh("base_link", _hull(0.15, 0.075, "z"))]
    depth = 6
    for name, _, pos, quat, joint, axis, length, radius, armature, _ in _ARM:
        pad = " " * depth
        q = _body_quat(quat, joint)
        arm += [f'{pad}<body name="{P}{name}" pos="{pos[0]} {pos[1]} {pos[2]}"{q}>',
                f'{pad}  <joint name="{P}{joint}" type="hinge" axis="{_JOINT_AXIS[joint]}" '
                f'range="-6.283185 6.283185" damping="1" armature="{armature}"/>',
                f"{pad}  " + mesh(name, _hull(length, radius, axis))]
        depth += 2
    pad = " " * depth
    arm += _gripper(pad, mesh)
    for d in range(depth - 2, 2, -2):
        arm.append(" " * d + "</body>")

    blocks = []
    h = np.broadcast_to(np.asarray(block_size, np.float64), (3,))
    for i in range(max_num_objects):
        blocks += [
            f'    <body name="object{i}" pos="0.0 0.0 0.0">',
            f'      <geom name="object{i}" type="box" rgba="0.8 0.4 0.1 1.0" '
            f'size="{h[0]} {h[1]} {h[2]}" density="1000"/>',
            f'      <joint name="object{i}:joint" type="free"/>',
            "    </body>",
        ]
    links = ["base_link"] + [a[0] for a in _ARM]
    grip = ["gripper_base", "left_outer_driver", "left_inner_follower", "left_gripper",
            "right_outer_driver", "right_inner_follower", "right_gripper"]
    gname = {g: (P + g if g == "gripper_base" else g) for g in grip}
    pairs = [(P + a, P + b) for i, a in enumerate(links) for b in links[i + 1:]]
    pairs += [(P + a, gname[g]) for a in links for g in grip]
    pairs += [(gname[a], gname[b]) for i, a in enumerate(grip) for b in grip[i + 1:]
              if {a, b} != {"left_gripper", "right_gripper"}]
    excludes = [f'    <exclude body1="{a}" body2="{b}"/>' for a, b in pairs]

    equality = [
        f'    <joint name="{P}gripper_coupling" joint1="{P}l_gripper_LJ0_outer" '
        f'joint2="{P}r_gripper_RJ0_outer" polycoef="0 1 0 0 0"/>',
        f'    <connect name="{P}left_four_bar" body1="left_inner_follower" body2="left_gripper" '
        f'anchor="0 0 {_LINK}"/>',
        f'    <connect name="{P}right_four_bar" body1="right_inner_follower" '
        f'body2="right_gripper" anchor="0 0 {_LINK}"/>',
    ]
    actuators = []
    if joint_actuated:
        for i, (_, _, _, _, joint, *_, gains) in enumerate(_ARM):
            actuators.append(
                f'    <general name="ur_actuator_{i + 1}" joint="{P}{joint}" gaintype="user" '
                f'biastype="user" user="1" gainprm="{gains}" ctrlrange="-6.283185 6.283185"/>')
    else:
        equality.append(f'    <weld name="mocap_weld" body1="{P}mocap" body2="{P}gripper_tcp" '
                        'solref="0.02 1"/>')
    actuators.append(f'    <position name="{P}r_gripper_finger_joint" '
                     f'joint="{P}r_gripper_RJ0_outer" kp="20" '
                     f'ctrlrange="{DRIVER_RANGE[0]} {DRIVER_RANGE[1]}"/>')
    tx, ty, tz = TABLE_HALF
    return "\n".join([
        "<mujoco>",
        f'  <compiler angle="radian" meshdir="{directory}"/>',
        f'  <option timestep="{timestep}" gravity="0 0 -9.81"/>',
        "  <asset>",
        *assets,
        "  </asset>",
        "  <worldbody>",
        '    <geom name="floor" type="plane" size="4 4 0.1" pos="0 0 0"/>',
        f'    <body name="table" pos="{TABLE_POS[0]} {TABLE_POS[1]} {TABLE_POS[2]}">',
        f'      <geom name="table" type="box" size="{tx} {ty} {tz}"/>',
        "    </body>",
        f'    <body name="{P}mocap" mocap="true" pos="0 0 1"/>',
        *arm,
        *blocks,
        "  </worldbody>",
        "  <contact>",
        *excludes,
        "  </contact>",
        "  <equality>",
        *equality,
        "  </equality>",
        "  <actuator>",
        *actuators,
        "  </actuator>",
        "</mujoco>",
    ]) + "\n"


def _gripper(pad: str, mesh) -> List[str]:
    """The gripper's bodies under wrist_3, each line indented by `pad`."""
    P = PREFIX
    out = [f'{pad}<body name="{P}gripper_base" pos="0 0.117 0" '
           'quat="0.7071067811865476 -0.7071067811865476 0 0">',
           f"{pad}  " + mesh("gripper_base", _box_hull((0.045, 0.03, _C_Z / 2)))]
    for side, sx, axis, prefix in (("right", 1.0, "0 -1 0", "r_gripper_R"),
                                   ("left", -1.0, "0 1 0", "l_gripper_L")):
        ax, cx = sx * _A_X, sx * _C_X
        # the finger's origin is the follower's tip D = C + (0, 0, L); its
        # hinge sits at the driver's tip B = A + (0, 0, L)
        dx, dz = cx - ax, _C_Z - _PIVOT_Z
        rng = f'range="{DRIVER_RANGE[0]} {DRIVER_RANGE[1]}"'
        out += [
            f'{pad}  <body name="{side}_outer_driver" pos="{ax} 0 {_PIVOT_Z}">',
            f'{pad}    <joint name="{P}{prefix}J0_outer" type="hinge" axis="{axis}" {rng} '
            'damping="0.1" armature="0.001"/>',
            f"{pad}    " + mesh(f"{side}_outer_driver", _hull(_LINK, 0.008, "z")),
            f'{pad}    <body name="{side}_gripper" pos="{dx} 0 {_LINK + dz}">',
            f'{pad}      <joint name="{P}{prefix}J1" type="hinge" axis="{axis}" '
            f'pos="{-dx} 0 {-dz}" limited="false" damping="0.1" armature="0.001"/>',
            f"{pad}      " + mesh(f"{side}_gripper",
                                  _pad_hull(sx)),
            f"{pad}    </body>",
            f"{pad}  </body>",
            f'{pad}  <body name="{side}_inner_follower" pos="{cx} 0 {_C_Z}">',
            f'{pad}    <joint name="{P}{prefix}J0_inner" type="hinge" axis="{axis}" '
            'limited="false" damping="0.1" armature="0.001"/>',
            f"{pad}    " + mesh(f"{side}_inner_follower", _hull(_LINK, 0.006, "z")),
            f"{pad}  </body>",
        ]
    out += [f'{pad}  <body name="{P}gripper_tcp" pos="0 0 {TCP_Z}"/>', f"{pad}</body>"]
    return out


def _pad_hull(sx: float) -> np.ndarray:
    """A finger: a slab from its origin down the gripper's axis, its inner
    face toward the gripper's centre line (sx = +1 right, -1 left)."""
    x_in, x_out = -0.004 * sx - 0.008 * sx, 0.004 * sx
    pts = [(x, y, z) for x in (x_in, x_out) for y in (-0.011, 0.011) for z in (-0.006, 0.045)]
    return np.asarray(pts)
