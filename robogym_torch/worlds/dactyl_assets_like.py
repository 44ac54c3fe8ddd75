"""A stand-in of robogym's assets directory for the dactyl world builders.

The dactyl envs compose their worlds from robogym's asset XMLs
(`robogym_torch/envs/dactyl/cube_env.build_cube_world_xml`,
`face_perpendicular.build_face_world_xml`,
`full_perpendicular.build_full_world_xml`, `reach.build_reach_xml`, and
their counterparts in `robogym_tpu`). Those assets are not part of this
repository, so `write_assets(root)` writes the six files the builders
parse, under `root/xmls/`, with the stand-in worlds' pieces and their
names unprefixed (each builder adds the prefix):

  * `robot/shadowhand/main.xml`: the hand of `dactyl_locked_like.py` (24
    hinges, 20 position actuators, 4 tendons, a box palm, the fingertip
    and phasespace sites) inside a body `hand_mount`, which the builders
    place at (1.0, 1.25, 0.15), euler (pi/2, 0, pi). Inside the mount a
    fixed body `hand_frame` turns and moves the stand-in's links so that
    the palm faces up under the builders' cube position (1.0, 0.87, 0.2),
    the fingers pointing along -y, with the cube's rest height over the
    palm of `dactyl_locked_like`. The mount also holds two objects that
    the builders remove: a geom `hand_base` and a site
    `annotation:outer_bound`;
  * `rubik/rubik_locked.xml`: the cube of `dactyl_locked_like.py` (body
    `middle` on slides `cube_tx/ty/tz` and a ball `cube_rot`, its box geom
    `middle`, a site `center`) and a site `annotation:outer_bound`, which
    the cube builder removes. It parses the file twice, as `cube:` and as
    `target:`;
  * `rubik/rubik_perpendicular.xml`: the pieces of `rubik_full_like.py`
    (6 face centres on drivers, 20 cubelets on three hinges each), each
    cubelet with a hinge `cubelet:spring:<name>` besides (both Rubik's
    builders remove them), and a site `annotation:outer_bound`, which they
    keep;
  * `floor/basic_floor.xml`: a body `floor` holding a plane;
  * `light/default.xml`: one directional light (`vision_like.LIGHT`);
  * `shadowhand_reach/target.xml`: the five target sites of
    `dactyl_reach_like.py` on a body `target`.

The hand's STL files go under `root/stls/`, where the builders' compiler
directive points `meshdir` (`MjcfXML.add_default_compiler_directive`).
Point a package at the tree by setting `ROBOGYM_TPU_ASSETS` to `root`
before it is imported, or its `xml_tools` module's directories after.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from robogym_torch.worlds import (dactyl_locked_like, dactyl_reach_like, rubik_full_like,
                                  vision_like)

# the builders' poses (cube_env.py, face_perpendicular.py, full_perpendicular.py, reach.py)
MOUNT_POS = (1.0, 1.25, 0.15)
MOUNT_EULER = (np.pi / 2, 0.0, np.pi)
CUBE_POS = (1.0, 0.87, 0.2)
# an annotation site (no mass, no contact): the locked cube's and the
# hand's are removed by the builders, the perpendicular cube's is kept by
# the Rubik's builders
OUTER_BOUND = '      <site name="annotation:outer_bound" pos="0 0 0" size="0.05"/>'


def _qmul(a, b) -> np.ndarray:
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array([w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2, w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
                     w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2, w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2])


def _qmat(q) -> np.ndarray:
    w, x, y, z = q
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
                     [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
                     [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def hand_frame_pose():
    """(pos, quat) of `hand_frame` in the mount's frame: the stand-in's
    links turned by -pi/2 about z in the world (their +x, along the
    fingers, to -y) and placed so that the cube position sits over the
    palm as `dactyl_locked_like.CUBE_POS` sits over it in that world."""
    e = MOUNT_EULER
    # the compilers' euler: q = qx(e0) qy(e1) qz(e2)
    q_mount = _qmul(_qmul([np.cos(e[0] / 2), np.sin(e[0] / 2), 0, 0],
                          [np.cos(e[1] / 2), 0, np.sin(e[1] / 2), 0]),
                    [np.cos(e[2] / 2), 0, 0, np.sin(e[2] / 2)])
    q_world = np.array([np.cos(-np.pi / 4), 0.0, 0.0, np.sin(-np.pi / 4)])
    r_world = _qmat(q_world)
    # the world position of the stand-in's origin (its wrist sits at
    # (0, 0, HAND_HEIGHT) above it)
    origin = np.asarray(CUBE_POS) - r_world @ np.asarray(dactyl_locked_like.CUBE_POS)
    r_mount = _qmat(q_mount)
    pos = r_mount.T @ (origin - np.asarray(MOUNT_POS))
    quat = _qmul(q_mount * np.array([1, -1, -1, -1]), q_world)
    return pos, quat / np.linalg.norm(quat)


def _floats(v) -> str:
    return " ".join(repr(float(x)) for x in v)


def hand_xml(stl_dir: str) -> str:
    """The hand file's text; writes the link hulls into `stl_dir`."""
    hand = dactyl_locked_like.hand_parts(stl_dir, prefix="")
    pos, quat = hand_frame_pose()
    bodies: List[str] = [
        '    <body name="hand_mount" pos="0 0 0">',
        '      <geom name="hand_base" type="box" pos="0 0 0.02" size="0.04 0.04 0.02" '
        'density="1000"/>',
        OUTER_BOUND,
        f'      <body name="hand_frame" pos="{_floats(pos)}" quat="{_floats(quat)}">',
        *["    " + line for line in hand["bodies"]],
        "      </body>",
        "    </body>",
    ]
    # the stand-in's meshes name their files relative to the mesh directory
    return "\n".join(["<mujoco>", "  <asset>", *hand["assets"], "  </asset>",
                      "  <worldbody>", *bodies, "  </worldbody>",
                      "  <contact>", *hand["excludes"], "  </contact>",
                      "  <tendon>", *hand["tendons"], "  </tendon>",
                      "  <actuator>", *hand["actuators"], "  </actuator>",
                      "</mujoco>"]) + "\n"


def _with_outer_bound(lines: List[str]) -> List[str]:
    """A cube's body lines with the outer-bound site as its body's last child."""
    return lines[:-1] + [OUTER_BOUND, lines[-1]]


def locked_cube_xml() -> str:
    lines = dactyl_locked_like._cube("", (0, 0, 0), target=False)
    return "\n".join(["<mujoco>", "  <worldbody>", *_with_outer_bound(lines), "  </worldbody>",
                      "</mujoco>"]) + "\n"


def perpendicular_cube_xml() -> str:
    """The 26 pieces of `rubik_full_like`, unprefixed, a spring hinge on
    each cubelet after its three rotation hinges."""
    out = []
    for line in rubik_full_like.cube_lines((0, 0, 0), prefix=""):
        out.append(line)
        if 'name="cubelet:rotz:' in line:
            name = line.split('name="cubelet:rotz:')[1].split('"')[0]
            out.append(f'        <joint name="cubelet:spring:{name}" type="hinge" '
                       'axis="0 0 1" stiffness="0.1"/>')
    return "\n".join(["<mujoco>", "  <worldbody>", *_with_outer_bound(out), "  </worldbody>",
                      "</mujoco>"]) + "\n"


def floor_xml() -> str:
    return "\n".join(["<mujoco>", "  <worldbody>", '    <body name="floor" pos="0 0 0">',
                      '      <geom name="floor" type="plane" size="1 1 0.1"/>', "    </body>",
                      "  </worldbody>", "</mujoco>"]) + "\n"


def light_xml() -> str:
    return "\n".join(["<mujoco>", "  <worldbody>", vision_like.LIGHT, "  </worldbody>",
                      "</mujoco>"]) + "\n"


def target_xml() -> str:
    sites = [f'      <site name="target:{s}" pos="{_floats(q)}" size="0.005"/>'
             for s, q in dactyl_reach_like._TARGETS]
    return "\n".join(["<mujoco>", "  <worldbody>", '    <body name="target" pos="0 0 0">',
                      *sites, "    </body>", "  </worldbody>", "</mujoco>"]) + "\n"


def write_assets(root: str) -> Dict[str, str]:
    """Write the six XML files under `root/xmls` and the hand's STLs under
    `root/stls`: {file under xmls: its path}."""
    root = os.path.abspath(root)
    texts = {"robot/shadowhand/main.xml": hand_xml(os.path.join(root, "stls")),
             "rubik/rubik_locked.xml": locked_cube_xml(),
             "rubik/rubik_perpendicular.xml": perpendicular_cube_xml(),
             "floor/basic_floor.xml": floor_xml(), "light/default.xml": light_xml(),
             "shadowhand_reach/target.xml": target_xml()}
    out = {}
    for name, text in texts.items():
        path = os.path.join(root, "xmls", name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(text)
        out[name] = path
    return out
