"""The goal-settle world of rearrange/table_setting: five free convex-mesh
objects on a table.

rearrange/table_setting places five YCB tableware meshes, a plate, two
forks, a knife and a spoon (`envs/rearrange/table_setting.py`, `SLOT_MESHES`
at `SLOT_SCALES`), and its goal settle steps an objects-only copy of the
world (`envs/rearrange/simulation.py` `build_settle_world_xml`, stepped in
`envs/rearrange/blocks.py` `_stabilize_goal`): the floor, the table and the
free objects, with no arm, no actuators and no tendons, at a 1 ms timestep.

The YCB meshes and the UR16e table are not part of this repository, so this
module writes stand-ins with the same structure: the floor plane, the
static box table of `blocks_settle_like`, and each object as a convex hull
of its scaled size, written as ASCII STL beside the MJCF:
  * the plate, about 0.156 m across and 0.015 m high: a frustum whose 30-vert
    rim ring (radius 0.078 m) sits above a 30-vert foot ring (0.048 m);
  * the two forks and the knife, 0.115 x 0.015 x 0.008 m and 0.13 x 0.013 x
    0.008 m, and the spoon, 0.126 x 0.025 x 0.013 m: a 30-sided outline
    stretched to the object's length and width, at two heights;
  * under each, four feet 1 mm below its bottom ring, at 45, 135, 225 and
    315 degrees.
Every hull has 64 verts, the compiler's limit (`MAX_HULL_VERTS`), and the
density is 1000.

Three things in the JAX package's collision driver, which the port repeats,
shape the stand-in so that objects can rest:
  * a box against a mesh takes the 4-point manifold with the box's 8
    corners as side 1; against a table far larger than the object no corner
    lies over the object's footprint, so the manifold falls back to one
    point halfway between the table top's centroid and the object's bottom,
    and the objects tip into the table. So the objects rest on a plane at
    the table's height (`top`), and the box table stands 1 cm lower: its 5
    pairs with the objects still run that manifold, a centimetre apart;
  * a plane against a mesh breaks ties between its verts with an index ramp
    scaled by the largest |depth| of the env's pairs, and padded verts
    count at 1e10, so with a mesh of fewer than 64 verts in the env the
    four picks follow the vert index rather than the depth. So every hull
    has 64 verts. Even then exact ties go to the lower index, and the
    compiler numbers verts in the order of their coordinates, so the four
    picks on a flat face sit at one end of it; the feet make the four
    deepest verts of an object lying flat a wide quad;
  * a mesh against a mesh has no face normal among its directions, so the
    sweep's normal for a flat object lying on another ends about 10 degrees
    from the vertical unless the line between their centres is near it. So
    the spoon starts close above the plate's centre.

Pairs: 5 table-object (box against mesh, side 1 the table's 8 corners), 10
object-object (mesh against mesh between free bodies, the 4-point manifold
with the first object's hull as side 1) and 10 plane-object (the floor and
the table top).

Pure Python and numpy: `write(directory)` writes the STL files and returns
the MJCF text. The compiled model, with the contact budgets that
`scale_contact_budgets(model, 5)` gives it, ships as `table_setting_like.npz`
next to this file (see `tools/build_locked_like_snapshot.py`);
`initial_state` draws seeded start states for it.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from robogym_torch.worlds.blocks_settle_like import TABLE_HALF, TABLE_TOP
from robogym_torch.worlds.locked_like import _stl

SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "table_setting_like.npz")
# the slots of table_setting.py, in its order: (name, length, width, height)
OBJECTS = (("plate", 0.156, 0.156, 0.015), ("fork0", 0.115, 0.015, 0.008),
           ("fork1", 0.115, 0.015, 0.008), ("knife", 0.13, 0.013, 0.008),
           ("spoon", 0.126, 0.025, 0.013))
N_OBJECTS = len(OBJECTS)
SIDES = 30           # outline verts at each of two heights, and 4 feet: 64 hull verts
PLATE_FOOT = 0.048   # m, radius of the plate's foot ring
FOOT_DROP = 0.001    # m from the bottom ring down to the feet
SPOON = 4            # the object that starts on the plate in every other env
TABLE_DROP = 0.01    # m from the table top (the plane) down to the box table

_FREE = 0
_GRID = 4            # start cells per side on the table top
_CELL = 0.18         # m between cell centres: objects at any yaw cannot touch
_JITTER = 0.01       # m
_ON_PLATE = 0.002    # m, the spoon's largest offset from the plate's centre, per axis


def object_verts(name: str) -> np.ndarray:
    """The hull verts (64, 3) of an object, centred on its body's origin:
    a regular 30-gon stretched to the object's length and width at its top,
    the same at its bottom (the plate's shrunk to its foot), and four feet
    below the bottom ring, inside it."""
    _, length, width, height = next(o for o in OBJECTS if o[0] == name)
    ang = (np.arange(SIDES) + 0.5) * (2 * np.pi / SIDES)
    unit = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    top = unit / np.abs(unit).max(axis=0) * (0.5 * length, 0.5 * width)
    shrink = 2 * PLATE_FOOT / length if name == "plate" else 1.0
    diag = np.asarray([(1, 1), (-1, 1), (-1, -1), (1, -1)]) * np.sqrt(0.5)
    feet = 0.8 * shrink * diag * (0.5 * length, 0.5 * width)
    h = 0.5 * height
    return np.concatenate([np.concatenate([shrink * top, np.full((SIDES, 1), -h)], axis=1),
                           np.concatenate([top, np.full((SIDES, 1), h)], axis=1),
                           np.concatenate([feet, np.full((4, 1), -h - FOOT_DROP)], axis=1)])


def write(directory: str) -> str:
    """Write the objects' hulls as ASCII STL into `directory` and return the
    MJCF text (mesh paths are absolute)."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    assets, bodies = [], []
    for name, *_ in OBJECTS:
        with open(os.path.join(directory, f"{name}.stl"), "w") as f:
            f.write(_stl(object_verts(name)))
        assets.append(f'    <mesh name="{name}" file="{name}.stl"/>')
        bodies += [
            f'    <body name="{name}" pos="0 0 0">',
            f'      <geom name="{name}" type="mesh" mesh="{name}" density="1000"/>',
            f'      <joint name="{name}:joint" type="free"/>',
            "    </body>",
        ]
    hx, hy = TABLE_HALF[:2]
    hz = 0.5 * (TABLE_TOP - TABLE_DROP)
    return "\n".join([
        "<mujoco>",
        f'  <compiler angle="radian" coordinate="local" meshdir="{directory}"/>',
        '  <option timestep="0.001" gravity="0 0 -9.81"/>',
        "  <asset>",
        *assets,
        "  </asset>",
        "  <worldbody>",
        '    <geom name="floor" type="plane" size="2 2 0.1" pos="0 0 0"/>',
        f'    <body name="table" pos="0 0 {hz}">',
        f'      <geom name="table" type="box" size="{hx} {hy} {hz}"/>',
        "    </body>",
        f'    <geom name="top" type="plane" size="{hx} {hy} 0.1" pos="0 0 {TABLE_TOP}"/>',
        *bodies,
        "  </worldbody>",
        "</mujoco>",
    ]) + "\n"


def initial_state(arrays, batch: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded start states from the snapshot's arrays (`np.load` of
    `SNAPSHOT`): (qpos (B, nq), ctrl (B, 0)), float32.

    Each object lies flat 1 to 5 mm above the table top at a random yaw, in
    its own cell of a 4 x 4 grid of 0.18 m cells around the table's centre,
    jittered by up to 1 cm, so no two objects touch. In every other env (the
    odd ones) the spoon starts on the plate instead, 1 to 5 mm above it and
    within 2 mm of its centre along x and y, so mesh-mesh pairs are live."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(arrays["model.qpos0"], np.float64), (batch, 1))
    jtype = np.asarray(arrays["const.jnt_type"])
    adr = np.asarray(arrays["const.jnt_qposadr"])[jtype == _FREE]
    n = len(adr)
    half_h = np.asarray([0.5 * o[3] for o in OBJECTS])
    cells = np.argsort(rng.random((batch, _GRID * _GRID)), axis=1)[:, :n]
    centre = (np.arange(_GRID) - (_GRID - 1) / 2) * _CELL
    xy = np.stack([centre[cells // _GRID], centre[cells % _GRID]], axis=-1)
    xy += rng.uniform(-_JITTER, _JITTER, xy.shape)
    z = TABLE_TOP + half_h + FOOT_DROP + rng.uniform(0.001, 0.005, (batch, n))
    on_plate = np.arange(batch) % 2 == 1
    k = int(on_plate.sum())
    xy[on_plate, SPOON] = xy[on_plate, 0] + rng.uniform(-_ON_PLATE, _ON_PLATE, (k, 2))
    z[on_plate, SPOON] = (z[on_plate, 0] + half_h[0] + half_h[SPOON] + FOOT_DROP
                          + rng.uniform(0.001, 0.005, k))
    yaw = rng.uniform(-np.pi, np.pi, (batch, n))
    for j, a in enumerate(adr):
        qpos[:, a:a + 2] = xy[:, j]
        qpos[:, a + 2] = z[:, j]
        qpos[:, a + 3:a + 7] = np.stack([np.cos(yaw[:, j] / 2), np.zeros(batch), np.zeros(batch),
                                         np.sin(yaw[:, j] / 2)], axis=1)
    ctrl = np.zeros((batch, 0), np.float32)
    return qpos.astype(np.float32), ctrl
