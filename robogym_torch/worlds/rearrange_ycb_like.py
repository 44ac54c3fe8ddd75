"""The YCB rearrange world's stand-in: the UR16e-shaped arm, gripper and
table of `rearrange_blocks_like` with `MAX_NUM_OBJECTS` mesh-object slots,
and six candidate meshes of YCB-like shapes for its mesh bank.

The YCB meshes are not part of this repository, so this module writes six
stand-ins as ASCII STL of their convex hulls, one directory each as the
YCB models ship (`<name>/<name>.stl`), in metres at roughly their YCB
sizes:
  * `can`: a 32-sided prism, 0.066 m across and 0.1 m high (64 verts);
  * `cracker_box`: a box 0.16 x 0.06 x 0.21 m with rounded vertical edges
    and bevelled ends (4 rings of 16 points: 64 verts);
  * `banana`: an elongated hull of 16 sections of 8 points along an arc
    about 0.19 m long, thinning at its ends (more than 64 hull verts: the
    bank's farthest-point cut runs);
  * `bottle`: a 24-sided body 0.07 m across up to 0.14 m, a shoulder, and a
    neck 0.03 m across up to 0.22 m (72 hull verts: the cut runs);
  * `bowl`: a 32-sided frustum, 0.06 m across its foot and 0.15 m across its
    rim, 0.055 m high (64 verts);
  * `die`: a 6-sided prism 0.03 m across and high (12 verts: the bank pads
    it).
The JAX package's plane-mesh contact, which the port repeats, picks the
four deepest verts of a mesh by an index ramp whose scale a padded vert
inflates to 1e4 a vert index in every env that holds one (ROADMAP section
3, item 5): there the picks follow the index, and objects sink into the
table and spin. With every candidate padded but the can, a reset of 32
envs left objects up to 4 cm in the table's top, and the banana spinning
at 1141 rad/s; with the can alone, at rest. So every candidate but the
die has 64 hull verts.

The world (`rearrange_ycb_like.npz`, compiled by
`tools/build_locked_like_snapshot.py rearrange_ycb_like` as the JAX mesh
env's `_compile_world` builds it, `robogym_tpu/envs/rearrange/mesh.py:
211-227`) is `rearrange_blocks_like.write(directory, 0)` with
`MAX_NUM_OBJECTS` slots `object{i}`, each a free body with one mesh geom of
the first candidate (by name) at scale 1 and density 1000, and the contact
budgets of `scale_contact_budgets(model, MAX_NUM_OBJECTS)`. Each episode
swaps its slots' hulls, masses and inertias for those of the candidates it
draws (`envs/rearrange/mesh.py`).

The world also holds `table_top`, a fixed body whose plane lies on the
table's top and collides with the objects alone (`table_top_xml`). The JAX
package's collision driver, which the port repeats, takes a box against a
mesh as a 4-point manifold with the box's 8 corners as side 1; against a
table far larger than the object no corner lies over the object's
footprint, so the manifold falls back to one point and a resting object
tips into the table (with the box alone the JAX env's reset left objects
0.07 to 0.16 m under the table's top and spinning at up to 1.7e3 rad/s).
The plane's pairs take the object's four deepest verts and hold it on the
top; the box's pairs stay, at the same height.

Pairs: the objects against each other and against the arm's and the
gripper's links are mesh-mesh pairs of free bodies (kernel C's 4-point
manifold), the table against the objects and the links box-mesh (kernel
C), the two fingers mesh-mesh (kernel D), the floor against every hull and
the table's top against the objects plane pairs. No box-box pair: kernel E
does not run in this world.

Pure Python and numpy: `write_candidates(directory)` writes the STLs;
`MESH_DIR` holds the committed copies.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from scipy.spatial import ConvexHull

from robogym_torch.worlds import rearrange_blocks_like

MAX_NUM_OBJECTS = 8
_HERE = os.path.dirname(os.path.abspath(__file__))
SNAPSHOT = os.path.join(_HERE, "rearrange_ycb_like.npz")
MESH_DIR = os.path.join(_HERE, "ycb_like")


def _ring(n: int, radius: float, z: float, phase: float = 0.0) -> np.ndarray:
    ang = np.arange(n) * (2 * np.pi / n) + phase
    return np.stack([radius * np.cos(ang), radius * np.sin(ang), np.full(n, z)], axis=1)


def _banana() -> np.ndarray:
    pts = []
    for i, t in enumerate(np.linspace(-0.7, 0.7, 16)):
        c = np.array([0.135 * np.sin(t), 0.0, 0.135 * (np.cos(t) - 1.0)])
        r = 0.018 * (1.0 - 0.55 * abs(t) / 0.7)
        normal = np.array([np.sin(t), 0.0, np.cos(t)])
        for a in np.arange(8) * (np.pi / 4) + (i % 2) * np.pi / 8:
            pts.append(c + r * (np.cos(a) * normal + np.sin(a) * np.array([0.0, 1.0, 0.0])))
    return np.asarray(pts)


def _rounded_box(hx: float, hy: float, hz: float, r: float, bevel: float) -> np.ndarray:
    """A box with rounded vertical edges (radius r, 4 points a corner) and
    bevelled ends: 4 rings of 16 points."""
    corners = [(hx - r, hy - r, 0.0), (-hx + r, hy - r, 0.5), (-hx + r, -hy + r, 1.0),
               (hx - r, -hy + r, 1.5)]
    ring = [(cx + r * np.cos(a), cy + r * np.sin(a))
            for cx, cy, q in corners for a in (q + np.arange(4) / 3.0 * 0.5) * np.pi]
    ring = np.asarray(ring)
    levels = [(-hz, 1.0 - bevel), (-hz + bevel * hz, 1.0), (hz - bevel * hz, 1.0), (hz, 1.0 - bevel)]
    return np.concatenate([np.concatenate([ring * s, np.full((16, 1), z)], axis=1)
                           for z, s in levels])


def candidates() -> Dict[str, np.ndarray]:
    """name -> the candidate's points (n, 3), in metres."""
    return {
        "can": np.concatenate([_ring(32, 0.033, -0.05), _ring(32, 0.033, 0.05)]),
        "cracker_box": _rounded_box(0.08, 0.03, 0.105, 0.01, 0.1),
        "banana": _banana(),
        "bottle": np.concatenate([_ring(24, 0.035, -0.11), _ring(24, 0.035, 0.03, np.pi / 24),
                                  _ring(24, 0.024, 0.065), _ring(24, 0.015, 0.11, np.pi / 24)]),
        "bowl": np.concatenate([_ring(32, 0.03, -0.0275), _ring(32, 0.075, 0.0275, np.pi / 32)]),
        "die": np.concatenate([_ring(6, 0.015, -0.015), _ring(6, 0.015, 0.015)]),
    }


def hull_stl(points: np.ndarray) -> str:
    """The outward-wound ASCII STL of the convex hull of `points`, one
    facet per triangle of scipy's hull."""
    hull = ConvexHull(points)
    center = points[hull.vertices].mean(axis=0)
    lines = ["solid hull"]
    for tri in hull.simplices:
        a, b, c = points[tri]
        nrm = np.cross(b - a, c - a)
        nrm = nrm / np.linalg.norm(nrm)
        if (a - center) @ nrm < 0:
            nrm, b, c = -nrm, c, b
        lines.append("  facet normal %r %r %r" % tuple(float(x) for x in nrm))
        lines.append("    outer loop")
        for p in (a, b, c):
            lines.append("      vertex %r %r %r" % tuple(float(x) for x in p))
        lines.append("    endloop")
        lines.append("  endfacet")
    lines.append("endsolid hull")
    return "\n".join(lines) + "\n"


def write_candidates(directory: str) -> Dict[str, str]:
    """Write each candidate as `<directory>/<name>/<name>.stl`; returns
    name -> path."""
    out = {}
    for name, pts in candidates().items():
        os.makedirs(os.path.join(directory, name), exist_ok=True)
        out[name] = os.path.join(directory, name, f"{name}.stl")
        with open(out[name], "w") as f:
            f.write(hull_stl(pts))
    return out


def table_top_xml() -> str:
    """The MJCF of `table_top`: a fixed body at the table's top whose plane
    collides with no link of the arm or the gripper."""
    P = rearrange_blocks_like.PREFIX
    top = rearrange_blocks_like.TABLE_POS[2] + rearrange_blocks_like.TABLE_HALF[2]
    links = [P + n for n in ("base_link", "shoulder_link", "upper_arm_link", "forearm_link",
                             "wrist_1_link", "wrist_2_link", "wrist_3_link", "gripper_base")]
    links += [f"{side}_{part}" for side in ("left", "right")
              for part in ("outer_driver", "inner_follower", "gripper")]
    tx, ty, _ = rearrange_blocks_like.TABLE_HALF
    return "\n".join([
        "<mujoco>",
        "  <worldbody>",
        f'    <body name="table_top" pos="0 0 {top}">',
        f'      <geom name="table_top" type="plane" size="{tx} {ty} 0.1"/>',
        "    </body>",
        "  </worldbody>",
        "  <contact>",
        *[f'    <exclude body1="table_top" body2="{b}"/>' for b in links],
        "  </contact>",
        "</mujoco>",
    ]) + "\n"
