"""Stand-in worlds with cameras and a light, for the vision observations.

The reference's camera and light poses live in its robot and scene XMLs,
which are not part of this repository; the poses here are this stand-in's
own choice, aimed so that each camera sees what its reference namesake
looks at:

  * `write_dactyl`: the dactyl-shaped hand-and-cube world
    (`dactyl_locked_like`) with the three cameras of the locked env's
    vision observations (`observation/dummy_vision.DEFAULT_CAMERA_NAMES`:
    `vision_cam_top`, `vision_cam_right`, `vision_cam_left`) aimed at the
    cube on the palm, from above and from either side, and one
    directional light from above;
  * `write_rearrange`: the UR16e-shaped blocks world
    (`rearrange_blocks_like`, 8 blocks, joint-actuated) with
    `vision_cam_front` over the table's front edge aimed at its centre, a
    `vision_cam_wrist` on the gripper looking down its axis, and one
    directional light.

The compiled snapshots `dactyl_vision_like.npz` and
`rearrange_vision_like.npz` are built by
`tools/build_locked_like_snapshot.py`; every other world stays as it was.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from robogym_torch.utils.rotation import _np_mat2quat
from robogym_torch.worlds import dactyl_locked_like, rearrange_blocks_like

_HERE = os.path.dirname(os.path.abspath(__file__))
DACTYL_SNAPSHOT = os.path.join(_HERE, "dactyl_vision_like.npz")
REARRANGE_SNAPSHOT = os.path.join(_HERE, "rearrange_vision_like.npz")
FOVY = 45.0
LIGHT = ('    <light name="light0" directional="true" pos="0 0 4" dir="0 0 -1" '
         'diffuse="0.6 0.6 0.6" ambient="0.15 0.15 0.15"/>')


def lookat_quat(eye, target, up=(0.0, 0.0, 1.0)) -> np.ndarray:
    """The quaternion of a camera at `eye` looking at `target` (MuJoCo's
    camera: -Z forward, +Y up)."""
    eye, target, up = (np.asarray(v, np.float64) for v in (eye, target, up))
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    if np.linalg.norm(x) < 1e-9:
        x = np.cross((0.0, 1.0, 0.0), z)
    x = x / np.linalg.norm(x)
    return _np_mat2quat(np.stack([x, np.cross(z, x), z], axis=1))


def camera_xml(name: str, eye, target, pad: str = "    ") -> str:
    q = lookat_quat(eye, target)
    return (f'{pad}<camera name="{name}" pos="{eye[0]} {eye[1]} {eye[2]}" '
            f'quat="{q[0]} {q[1]} {q[2]} {q[3]}" fovy="{FOVY}"/>')


def _insert_before(xml: str, marker: str, lines: List[str]) -> str:
    if xml.count(marker) != 1:
        raise ValueError(f"the stand-in's XML holds {marker!r} {xml.count(marker)} times")
    return xml.replace(marker, "\n".join(lines) + "\n" + marker)


def write_dactyl(directory: str) -> str:
    """The dactyl-shaped world's MJCF text with its cameras and light."""
    c = np.asarray(dactyl_locked_like.CUBE_POS)
    cams = [camera_xml("vision_cam_top", c + (0.02, 0.0, 0.32), c),
            camera_xml("vision_cam_right", c + (0.08, -0.30, 0.16), c),
            camera_xml("vision_cam_left", c + (0.08, 0.30, 0.16), c)]
    return _insert_before(dactyl_locked_like.write(directory), "  </worldbody>", cams + [LIGHT])


def write_rearrange(directory: str) -> str:
    """The blocks world's MJCF text (8 blocks, joint-actuated) with its
    cameras and light."""
    tx, ty, tz = rearrange_blocks_like.TABLE_HALF
    top = np.asarray(rearrange_blocks_like.TABLE_POS) + (0.0, 0.0, tz)
    front = camera_xml("vision_cam_front", top + (tx + 0.55, 0.0, 0.65), top)
    xml = _insert_before(rearrange_blocks_like.write(directory), "  </worldbody>",
                         [front, LIGHT])
    # the wrist camera on the gripper's base, looking along its axis (+z,
    # towards the fingertips): a turn of pi about x
    base = f'<body name="{rearrange_blocks_like.PREFIX}gripper_base"'
    head, rest = xml.split(base, 1)
    line_end = rest.index("\n") + 1
    wrist = '          <camera name="vision_cam_wrist" pos="0 -0.05 0.02" quat="0 1 0 0" ' \
            f'fovy="{FOVY}"/>\n'
    return head + base + rest[:line_end] + wrist + rest[line_end:]
