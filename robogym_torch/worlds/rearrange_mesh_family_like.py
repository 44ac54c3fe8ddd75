"""Stand-ins for the rest of the mesh rearrange envs: table setting,
chessboard, the mixture and the composer.

The meshes these envs draw from (the YCB tableware, the chess pieces,
robogym's `geom` shapes) are not part of this repository, so this module
writes stand-ins as ASCII STL of their convex hulls, one directory each
(`<name>/<name>.stl`), every hull with exactly 64 verts, the compiler's
limit: a padded hull inflates the plane-mesh contact's index ramp in every
env that holds one, and objects then sink and spin (ROADMAP section 3,
item 5; `rearrange_ycb_like`). Under `MESH_ROOT`:
  * `tableware/`: `029_plate`, `030_fork`, `031_spoon`, `032_knife`, the
    hulls of `table_setting_like.object_verts` (a 30-gon outline at two
    heights and four feet) scaled by `TABLEWARE_SCALE`, so that the plate
    is as large as the table setting's episodes make it (half-extent
    0.05 x 0.6 m);
  * `chess/`: `bishop`, `knight`, `queen`, `rook`, tall pieces on a round
    foot (a 32-gon foot ring and a smaller, offset or tilted top);
  * `geom/`: `box` (a box with rounded vertical edges and bevelled ends),
    `cylinder` (a 32-sided prism), `frustum` (a 32-sided frustum) and
    `spindle` (4 rings of 16 on a spheroid, the outer two flattened).
Normalised by the env's bank (largest half-extent `normalized_mesh_size`),
only their shapes matter to an episode. Their size matters to the compiled
world: the JAX package computes the constraint rows' diagApprox weights
once, from the compiled slot mesh's mass and inertia (the first
candidate's at its STL size), and every episode's objects keep them
(ROADMAP section 3, item 5). With the tableware at its real size (a plate
0.156 m across) the table setting's light, thin objects got rows far too
stiff: at B=1024 on an NVIDIA H100 the reset left 9 % of envs non-finite
(`tools/env_nan_probe.py`, PERF.md); at the episodes' size and
without the box's pairs below, none.

The worlds (`rearrange_<env>_like.npz`, compiled by
`tools/build_locked_like_snapshot.py` with the JAX env's own
`_compile_world` on `rearrange_blocks_like.write(directory, 0)` plus the
YCB stand-in's table top, `rearrange_ycb_like.table_top_xml`):
  * table setting: 5 mesh slots of `029_plate` (the first of
    `table_setting.MESH_NAMES`), budgets of `scale_contact_budgets(model, 5)`,
    and no pair between the table's box and the objects
    (`table_setting_contact_xml`): they rest on the table's top plane. The
    JAX package takes a box against a mesh as a manifold with the box's
    corners as side 1, which falls back to one point under a small
    object and tips it (ROADMAP section 3, item 5); with those pairs far
    more envs' thin tableware spun after the reset
    (`tools/env_nan_probe.py`);
  * chessboard: 4 mesh slots of `bishop`, budgets for 4;
  * mixture: 8 mesh slots of `geom/box` (the first of the merged bank),
    budgets for 8;
  * composer: 8 slots of 3 mesh sub-geoms each (`object{i}`,
    `object{i}:g1`, `object{i}:g2`), every sub-geom a copy of the YCB
    stand-in `banana` (the first of `rearrange_ycb_like.MESH_DIR`), budgets
    of `scale_contact_budgets(model, 8, 16)`.

Pure Python and numpy: `write_candidates(directory)` writes the STLs into
`directory/{tableware,chess,geom}`; `MESH_ROOT` holds the committed copies.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from robogym_torch.worlds import table_setting_like
from robogym_torch.worlds.rearrange_ycb_like import _ring, _rounded_box, hull_stl

_HERE = os.path.dirname(os.path.abspath(__file__))
MESH_ROOT = os.path.join(_HERE, "mesh_family_like")
TABLEWARE_DIR = os.path.join(MESH_ROOT, "tableware")
CHESS_DIR = os.path.join(MESH_ROOT, "chess")
GEOM_DIR = os.path.join(MESH_ROOT, "geom")
SNAPSHOTS = {env: os.path.join(_HERE, f"rearrange_{env}_like.npz")
             for env in ("table_setting", "chessboard", "mixture", "composer")}
# object slots of each world
SLOTS = {"table_setting": 5, "chessboard": 4, "mixture": 8, "composer": 8}
COMPOSER_SUB_GEOMS = 3
# the table setting's plate (0.156 m across) at its episodes' half-extent
TABLEWARE_SCALE = 0.05 * 0.6 / (0.5 * 0.156)


def _tilted_ring(n: int, radius: float, z: float, tilt: float, phase: float = 0.0):
    ring = _ring(n, radius, z, phase)
    ring[:, 2] += tilt * ring[:, 0]
    return ring


def tableware() -> Dict[str, np.ndarray]:
    """The table-setting candidates by their YCB names."""
    def v(name):
        return TABLEWARE_SCALE * table_setting_like.object_verts(name)

    return {"029_plate": v("plate"), "030_fork": v("fork0"), "031_spoon": v("spoon"),
            "032_knife": v("knife")}


def table_setting_contact_xml(n_objects: int = SLOTS["table_setting"]) -> str:
    """The MJCF that keeps the table's box from colliding with the table
    setting's `n_objects` object slots."""
    return "\n".join(["<mujoco>", "  <contact>",
                      *[f'    <exclude body1="table" body2="object{i}"/>'
                        for i in range(n_objects)],
                      "  </contact>", "</mujoco>"]) + "\n"


def chess_pieces() -> Dict[str, np.ndarray]:
    """Four pieces 0.04 m across their foot: 32 foot points and 32 of a
    top ring (the knight's top shifted sideways, the bishop's tilted)."""
    foot = _ring(32, 0.02, 0.0)
    return {
        "rook": np.concatenate([foot, _ring(32, 0.016, 0.05, np.pi / 32)]),
        "knight": np.concatenate([foot, _ring(32, 0.011, 0.055, np.pi / 32)
                                  + np.array([0.007, 0.0, 0.0])]),
        "bishop": np.concatenate([foot, _tilted_ring(32, 0.009, 0.06, 0.3, np.pi / 32)]),
        "queen": np.concatenate([foot, _ring(32, 0.013, 0.07, np.pi / 32)]),
    }


def geom_shapes() -> Dict[str, np.ndarray]:
    """Four primitive-like shapes of 64 hull verts."""
    spindle = [_ring(16, r, z, k * np.pi / 16)
               for k, (r, z) in enumerate(((0.02, -0.03), (0.03, -0.01), (0.03, 0.01),
                                           (0.02, 0.03)))]
    return {
        "box": _rounded_box(0.03, 0.025, 0.02, 0.006, 0.1),
        "cylinder": np.concatenate([_ring(32, 0.02, -0.025), _ring(32, 0.02, 0.025)]),
        "frustum": np.concatenate([_ring(32, 0.03, -0.02), _ring(32, 0.015, 0.02, np.pi / 32)]),
        "spindle": np.concatenate(spindle),
    }


GROUPS = {"tableware": tableware, "chess": chess_pieces, "geom": geom_shapes}


def write_candidates(directory: str) -> Dict[str, str]:
    """Write every stand-in as `<directory>/<group>/<name>/<name>.stl`;
    returns "<group>/<name>" -> path."""
    out = {}
    for group, shapes in GROUPS.items():
        for name, pts in shapes().items():
            path = os.path.join(directory, group, name, f"{name}.stl")
            os.makedirs(os.path.dirname(path), exist_ok=True)
            with open(path, "w") as f:
                f.write(hull_stl(pts))
            out[f"{group}/{name}"] = path
    return out
