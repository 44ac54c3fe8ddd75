"""A hand-and-Rubik's-cube world with the names and structure that the
full-perpendicular env binds to.

The reference builds this world from the perpendicular Rubik's cube asset
(`rubik/rubik_perpendicular.xml`, every face free to turn) and the Shadow
Hand (`robogym_tpu/envs/dactyl/full_perpendicular.py:36-61`); neither
asset is part of this repository, so this module writes a stand-in that
both packages' env code binds to (`full_perpendicular.py:88-121`,
`cube_manipulator.py:59-85`):

  * the hand of `dactyl_locked_like.py`, unchanged (24 hinges, 20 position
    actuators, 4 tendons, a box palm);
  * no target cube (goals are data), a floor plane;
  * the cube: a body `cube:middle` at the rest position of the
    dactyl-shaped world's cube, on three slides `cube:cube:tx/ty/tz` and a
    ball `cube:cube:rot`, with a site `cube:center` at its centre, and no
    geom of its own. Its 26 pieces are the boxes of `rubik_face_like.py`
    (half-size 0.009 m, 0.019 m apart, density 500), each in a body of its
    own, a child of `cube:middle` at its origin, the box offset to its grid
    cell:
      - 6 face centres `cube:cubelet:<face>` (neg_x, pos_x, ..., pos_z),
        each on one hinge `cube:cubelet:driver:<face>` about +x, +y or +z
        through the cube's centre (the axis `cube_manipulator.rotate_face`
        turns a face about, whichever side; its driver advances by the
        same angle), damped 0.002 N m s/rad as the face world's drivers,
        so that the face-damping randomization has something to scale;
      - 20 cubelets `cube:cubelet:<name>` (8 corners, 12 edges, named as
        `cube_manipulator._cubelet_names` gives them), each on three hinges
        `cube:cubelet:rotx|roty|rotz:<name>` about x, y and z through the
        cube's centre, listed in that order: MuJoCo composes a body's
        joints as R = R_x(e0) R_y(e1) R_z(e2), which is the manipulator's
        `euler2mat(e)`, so that a scrambled cubelet's box sits where the
        manipulator's matrices put it;
  * what holds the pieces: the real cubelets hold each other by their mesh
    contacts. Equality rows cannot stand in here (a turn changes which
    cubelets a face carries), so every piece hinge, drivers and cubelets,
    has a `frictionloss` of 1.0 N m and an armature of 0.01 kg m^2: a piece
    stays put against gravity, the reset's drop onto the palm and most
    finger pushes. The friction-loss rows reach the CG solve as such. With
    0.01 N m and no armature (about 10 times the gravity torque on a 2.9 g
    cubelet at 0.033 m) the reset's drop and the warmup's fingers twist
    single cubelets past 30 degrees, beyond which rounding their matrices
    no longer gives a legal cube: no reset state of a seeded batch of 32
    was one (`tools/rubik_hinge_sweep.py` measures the share);
  * the pieces collide with the hand and the floor, not with each other
    (contype 0, conaffinity 1), as in `rubik_face_like.py`: palm against a
    piece is a box-box pair (kernel E), finger against a piece a box-mesh
    pair (kernel C, DX=6).

nq = 24 + 3 + 4 + 6 + 60 = 97, nv = 24 + 6 + 66 = 96.

`write(directory)` writes the hand's STL files and
returns the MJCF text. The compiled model ships as `rubik_full_like.npz`
next to this file (see `tools/build_locked_like_snapshot.py`, which
compiles it as the full env compiles its world: plain `compile_xml`, the
default contact budgets).
"""

from __future__ import annotations

import os
from typing import List

from robogym_torch.envs.dactyl import cube_manipulator
from robogym_torch.worlds import dactyl_locked_like, rubik_face_like

SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rubik_full_like.npz")
FRICTIONLOSS = 1.0                                   # N m, on every piece hinge
ARMATURE = 0.01                                      # kg m^2, on every piece hinge
DRIVER_DAMPING = rubik_face_like.DRIVER_DAMPING      # N m s/rad
_AXES = ("1 0 0", "0 1 0", "0 0 1")


def _box(name: str, xyz, pad: str) -> str:
    h, s = rubik_face_like.CUBELET_HALF, rubik_face_like.SPACING
    pos = " ".join(f"{v * s:.6g}" for v in xyz)
    return (f'{pad}<geom name="{name}" type="box" pos="{pos}" size="{h:.6g} {h:.6g} {h:.6g}" '
            f'density="{rubik_face_like.DENSITY}"{rubik_face_like._COLLIDE}/>')


def _hinge(name: str, axis: str, damping: float = 0.0) -> str:
    damp = f' damping="{damping}"' if damping else ""
    return (f'        <joint name="{name}" type="hinge" axis="{axis}" '
            f'frictionloss="{FRICTIONLOSS}" armature="{ARMATURE}"{damp}/>')


def cube_lines(pos) -> List[str]:
    """The cube's bodies, joints, geoms and site under the worldbody."""
    out = [f'    <body name="cube:middle" pos="{pos[0]} {pos[1]} {pos[2]}">']
    for ax, axis in zip("xyz", _AXES):
        out.append(f'      <joint name="cube:cube:t{ax}" type="slide" axis="{axis}"/>')
    out.append('      <joint name="cube:cube:rot" type="ball"/>')
    out.append('      <site name="cube:center" pos="0 0 0"/>')
    for i, (driver, xyz) in enumerate(zip(cube_manipulator.DRIVER_NAMES,
                                          cube_manipulator.DRIVER_COORDS)):
        face = driver.rsplit(":", 1)[1]
        out += [f'      <body name="cube:cubelet:{face}" pos="0 0 0">',
                _hinge(f"cube:{driver}", _AXES[i // 2], DRIVER_DAMPING),
                _box(f"cube:cubelet:{face}", xyz, "        "),
                "      </body>"]
    for name, xyz in cube_manipulator._cubelet_names():
        out.append(f'      <body name="cube:cubelet:{name}" pos="0 0 0">')
        out += [_hinge(f"cube:cubelet:rot{a}:{name}", axis) for a, axis in zip("xyz", _AXES)]
        out += [_box(f"cube:cubelet:{name}", xyz, "        "), "      </body>"]
    out.append("    </body>")
    return out


def write(directory: str) -> str:
    """Write the hand's link hulls as ASCII STL into `directory` and return
    the MJCF text (mesh paths are absolute)."""
    return dactyl_locked_like.assemble(directory, dactyl_locked_like.hand_parts(directory),
                                       cube_lines(dactyl_locked_like.CUBE_POS))

