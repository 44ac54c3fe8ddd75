"""A hand-and-Rubik's-cube world with the names and structure that the
face-perpendicular env binds to.

The reference builds this world from the perpendicular Rubik's cube asset
(`rubik/rubik_perpendicular.xml`, with every joint but the two z faces'
removed) and the Shadow Hand (`robogym_tpu/envs/dactyl/face_perpendicular.py:
71-96`); neither asset is part of this repository, so this module writes a
stand-in that both packages' env code binds to
(`face_perpendicular.py:31-54`, `:139-165`):

  * the hand of `dactyl_locked_like.py`, unchanged: the `robot0:` names,
    the fingertip and phasespace sites, the box palm, 24 hinges, 20
    position actuators and 4 tendons;
  * no target cube: the face env has none (its `target_*_qpos` are empty);
    goals are data;
  * a floor plane;
  * the cube: a body `cube:middle` at the rest position of the
    dactyl-shaped world's cube, on three slides `cube:cube:tx/ty/tz` and a
    ball `cube:cube:rot`, with a site `cube:center` at its centre. Its 26
    cubelets sit on a 3 x 3 x 3 grid without the core, each a third of
    the locked cube's edge less a 1 mm gap (half-size 0.009 m, 0.019 m
    apart), density 500 as the locked cube. The 8 cubelets of the middle
    layer are geoms of `cube:middle` (`cube:cubelet:<x>_<y>`; none is named
    `cube:middle`, so the cube-size randomization finds no geom to scale,
    as on the real asset, whose middle body carries meshes). Each z face is
    9 bodies, children of `cube:middle` placed at its origin, their geoms
    offset to their grid cells: the centre carries the hinge
    `cube:cubelet:driver:pos_z` (or `neg_z`), each of the other 8 its
    `cube:cubelet:rotz:<x>_<y>_pos_z` (or `_neg_z`) hinge. Every hinge
    turns about the cube's z axis through its centre, has no range and no
    armature; the two drivers carry a damping of 0.002 N m s/rad (about
    0.15 s of decay on a face's 1.4e-5 kg m^2), so that the face-damping
    randomization has something to scale, the rotz hinges none;
  * each face held rigid by 8 `joint` equality rows, rotz = driver
    (polycoef 0 1 0 0 0), with the default solref. The real asset holds a
    face together by the contacts between its cubelet meshes; this world
    has no cubelet geometry that could, so the rows stand in for them,
    and they reach kernel B as equality rows;
  * the cubelets are boxes that collide with the hand and the floor, not
    with each other (contype 0, conaffinity 1 against the hand's and the
    floor's 1/1): palm against cubelet is a box-box pair (kernel E),
    finger against cubelet a box-mesh pair (kernel C, DX=6), so the
    contact set is one whose quality the port already knows. The real
    cubelets are meshes (`robogym_tpu/mjcf/mesh.py:187-190`), and hull
    cubelets would meet two faults of the reference that the port repeats
    (the box-side midpoint fallback against the palm, and mesh-mesh
    tilt).

nq = 24 + 3 + 4 + 18 = 49, nv = 24 + 6 + 18 = 48, as in the face env.

Pure Python and numpy: `write(directory)` writes the hand's STL files and
returns the MJCF text. The compiled model ships as `rubik_face_like.npz`
next to this file (see `tools/build_locked_like_snapshot.py`, which
compiles it as the face env compiles its world: plain `compile_xml`, the
default contact budgets).
"""

from __future__ import annotations

import os
from typing import List

from robogym_torch.worlds import dactyl_locked_like

SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "rubik_face_like.npz")
CUBE_HALF = dactyl_locked_like.CUBE_HALF
GAP = 0.001                              # between neighbouring cubelets (m)
SPACING = 2 * CUBE_HALF / 3              # centre to centre (m)
CUBELET_HALF = CUBE_HALF / 3 - GAP / 2   # 0.009 m
DRIVER_DAMPING = 0.002                   # N m s/rad
DENSITY = 500
_COLLIDE = ' contype="0" conaffinity="1"'


def _cell_name(ix: int, iy: int) -> str:
    """The grid cell's x and y part of a cubelet name: "neg_x_pos_y",
    "neg_x", "pos_y", or "" at the centre."""
    parts = [("neg_" if i < 0 else "pos_") + a for i, a in ((ix, "x"), (iy, "y")) if i]
    return "_".join(parts)


def _cells():
    return [(ix, iy) for ix in (-1, 0, 1) for iy in (-1, 0, 1)]


def _box(name: str, ix: int, iy: int, iz: int, pad: str) -> str:
    h, s = CUBELET_HALF, SPACING
    return (f'{pad}<geom name="{name}" type="box" pos="{ix * s:.6g} {iy * s:.6g} {iz * s:.6g}" '
            f'size="{h:.6g} {h:.6g} {h:.6g}" density="{DENSITY}"{_COLLIDE}/>')


def face_joint_names(face: str) -> List[str]:
    """The 9 hinges of z face `face` ("pos_z" or "neg_z"), the driver
    first, as `TOP_FACE_JOINTS` / `BOTTOM_FACE_JOINTS` list them."""
    return [f"cubelet:driver:{face}"] + [f"cubelet:rotz:{_cell_name(ix, iy)}_{face}"
                                         for ix, iy in _cells() if (ix, iy) != (0, 0)]


def cube_lines(pos) -> List[str]:
    """The cube's bodies, joints, geoms and site under the worldbody."""
    out = [f'    <body name="cube:middle" pos="{pos[0]} {pos[1]} {pos[2]}">']
    for ax, axis in zip("xyz", ("1 0 0", "0 1 0", "0 0 1")):
        out.append(f'      <joint name="cube:cube:t{ax}" type="slide" axis="{axis}"/>')
    out.append('      <joint name="cube:cube:rot" type="ball"/>')
    out.append('      <site name="cube:center" pos="0 0 0"/>')
    for ix, iy in _cells():
        if (ix, iy) != (0, 0):
            out.append(_box(f"cube:cubelet:{_cell_name(ix, iy)}", ix, iy, 0, "      "))
    for face, iz in (("pos_z", 1), ("neg_z", -1)):
        for ix, iy in _cells():
            cell = _cell_name(ix, iy)
            name = f"cube:cubelet:{cell + '_' if cell else ''}{face}"
            joint = (f"cube:cubelet:driver:{face}" if not cell
                     else f"cube:cubelet:rotz:{cell}_{face}")
            damping = f' damping="{DRIVER_DAMPING}"' if not cell else ""
            out += [f'      <body name="{name}" pos="0 0 0">',
                    f'        <joint name="{joint}" type="hinge" axis="0 0 1"{damping}/>',
                    _box(name, ix, iy, iz, "        "),
                    "      </body>"]
    out.append("    </body>")
    return out


def equality_lines() -> List[str]:
    """Each face's 8 rotz hinges held to its driver."""
    out = []
    for face in ("pos_z", "neg_z"):
        driver, *rotz = face_joint_names(face)
        out += [f'    <joint joint1="cube:{j}" joint2="cube:{driver}" polycoef="0 1 0 0 0"/>'
                for j in rotz]
    return out


def write(directory: str) -> str:
    """Write the hand's link hulls as ASCII STL into `directory` and return
    the MJCF text (mesh paths are absolute)."""
    return dactyl_locked_like.assemble(directory, dactyl_locked_like.hand_parts(directory),
                                       cube_lines(dactyl_locked_like.CUBE_POS), equality_lines())
