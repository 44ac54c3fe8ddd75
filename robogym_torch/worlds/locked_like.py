"""A hand-and-cube world with the structure of dactyl/locked.

The Shadow Hand assets are not part of this repository, so this module
writes a stand-in with the same structure: a palm-up hand of convex-hull
links (one mesh per body, written as ASCII STL beside the MJCF), 24 hinge
dofs (wrist 2; first, middle and ring fingers 4 each; little finger 5;
thumb 5), joint limits and damping on every hinge, 20 position actuators
(four of them drive a fixed tendon that couples J1+J0 of a finger, as the
Shadow Hand's do), a free cube of half-size 0.0285 m and a floor plane.

Pure Python and numpy: `write(directory)` writes the STL files and returns
the MJCF text. The compiled model ships as `locked_like.npz` next to this
file, and the hand-only variant (`write(directory, hand_only=True)`) as
`locked_like_hand.npz` (see `tools/build_locked_like_snapshot.py`);
`initial_state` draws seeded start states for either.
"""

from __future__ import annotations

import itertools
import os
from typing import Dict, List, Tuple

import numpy as np

_HINGE = 3
_FREE = 0

CUBE_HALF = 0.0285
PALM_HALF = (0.045, 0.045, 0.01)
HAND_HEIGHT = 0.25
SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "locked_like.npz")
HAND_SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "locked_like_hand.npz")

# (name, parent, pos in parent, joint axis, joint range, hull axis, length, radius)
_FINGER_Y = {"FF": 0.036, "MF": 0.012, "RF": -0.012}
_FLEX = "0 -1 0"


def _links() -> List[Tuple]:
    links = [
        ("wrist", None, (0.0, 0.0, HAND_HEIGHT), "0 0 1", (-0.489, 0.140), "x", -0.03, 0.015),
        ("palm", "wrist", (0.0, 0.0, 0.0), "0 -1 0", (-0.698, 0.489), None, 0.0, 0.0),
    ]
    for f, y in _FINGER_Y.items():
        links += [
            (f"{f}knuckle", "palm", (0.095, y, 0.0), "0 0 1", (-0.349, 0.349), "x", 0.01, 0.009),
            (f"{f}proximal", f"{f}knuckle", (0.012, 0.0, 0.0), _FLEX, (0.0, 1.571), "x", 0.045, 0.01),
            (f"{f}middle", f"{f}proximal", (0.047, 0.0, 0.0), _FLEX, (0.0, 1.571), "x", 0.025, 0.009),
            (f"{f}distal", f"{f}middle", (0.027, 0.0, 0.0), _FLEX, (0.0, 1.571), "x", 0.024, 0.008),
        ]
    links += [
        ("LFmetacarpal", "palm", (0.03, -0.036, 0.0), "-1 0 0", (0.0, 0.785), "x", 0.055, 0.009),
        ("LFknuckle", "LFmetacarpal", (0.065, 0.0, 0.0), "0 0 1", (-0.349, 0.349), "x", 0.01, 0.009),
        ("LFproximal", "LFknuckle", (0.012, 0.0, 0.0), _FLEX, (0.0, 1.571), "x", 0.04, 0.01),
        ("LFmiddle", "LFproximal", (0.042, 0.0, 0.0), _FLEX, (0.0, 1.571), "x", 0.022, 0.009),
        ("LFdistal", "LFmiddle", (0.024, 0.0, 0.0), _FLEX, (0.0, 1.571), "x", 0.022, 0.008),
        ("THbase", "palm", (0.03, 0.05, 0.0), "1 0 0", (-1.047, 1.047), "y", 0.012, 0.011),
        ("THproximal", "THbase", (0.0, 0.014, 0.0), "0 0 1", (0.0, 1.222), "y", 0.038, 0.011),
        ("THhub", "THproximal", (0.0, 0.04, 0.0), "1 0 0", (-0.209, 0.209), "y", 0.01, 0.01),
        ("THmiddle", "THhub", (0.0, 0.012, 0.0), "1 0 0", (-0.524, 0.524), "y", 0.032, 0.009),
        ("THdistal", "THmiddle", (0.0, 0.034, 0.0), "1 0 0", (-1.571, 0.0), "y", 0.027, 0.008),
    ]
    return links


def _joint_name(body: str) -> str:
    table = {"wrist": "WRJ1", "palm": "WRJ0", "LFmetacarpal": "LFJ4",
             "THbase": "THJ4", "THproximal": "THJ3", "THhub": "THJ2",
             "THmiddle": "THJ1", "THdistal": "THJ0"}
    if body in table:
        return table[body]
    finger, part = body[:2], body[2:]
    return finger + {"knuckle": "J3", "proximal": "J2", "middle": "J1", "distal": "J0"}[part]


def _prism(length: float, radius: float, axis: str) -> np.ndarray:
    """Octagonal prism with bevelled ends along `axis` from 0 to `length`
    (32 verts). A negative length extends the prism backwards."""
    ang = np.arange(8) * (np.pi / 4) + np.pi / 8
    ring = np.stack([np.cos(ang), np.sin(ang)], axis=1)
    lo, hi = (0.002, length) if length > 0 else (length, -0.002)
    bev = 0.4 * radius
    levels = [(lo, 0.7 * radius), (lo + bev, radius), (hi - bev, radius), (hi, 0.7 * radius)]
    pts = []
    for t, r in levels:
        for c, s in ring:
            pts.append((t, r * c, r * s) if axis == "x" else (r * c, t, r * s))
    return np.asarray(pts)


def _palm() -> np.ndarray:
    """Chamfered slab (16 verts) spanning x in [0, 0.09]."""
    hx, hy, hz = PALM_HALF
    ch = 0.008
    outline = [(-hx + ch, -hy), (hx - ch, -hy), (hx, -hy + ch), (hx, hy - ch),
               (hx - ch, hy), (-hx + ch, hy), (-hx, hy - ch), (-hx, -hy + ch)]
    return np.asarray([(x + hx, y, z) for z in (-hz, hz) for x, y in outline])


def _face_candidates(verts: np.ndarray, slack: float = 1e-12):
    """The triples (i < j < k, in lexicographic order) whose plane may have
    every point on one side: all of them screened in one batch, with a
    margin of `slack` over the face test's 1e-9 for the batch's rounding."""
    i, j, k = np.array(list(itertools.combinations(range(len(verts)), 3)), np.int64).T
    a = verts[i]
    nrm = np.cross(verts[j] - a, verts[k] - a)
    norm = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.where(norm > 0, norm, 1.0)
    side = np.einsum("tpd,td->tp", verts[None, :, :] - a[:, None, :], nrm)
    keep = ~((side.max(1) > 1e-9 + slack) & (side.min(1) < -1e-9 - slack))
    return zip(i[keep].tolist(), j[keep].tolist(), k[keep].tolist())


def _stl(verts: np.ndarray) -> str:
    """Convex point set -> outward-wound ASCII STL of its hull.

    Hull faces are found by brute force (every triple whose plane has all
    points on one side, grouped by the coplanar points it touches); each
    face is written once as a fan of triangles. The triples are screened
    at once (`_face_candidates`) and each one that passes is tested again
    on its own, in order, so the faces are those of the triple loop.
    """
    center = verts.mean(axis=0)
    faces: Dict[Tuple[int, ...], np.ndarray] = {}
    for i, j, k in _face_candidates(verts):
        a, b, c = verts[i], verts[j], verts[k]
        nrm = np.cross(b - a, c - a)
        norm = np.linalg.norm(nrm)
        if norm < 1e-12:
            continue
        nrm = nrm / norm
        side = (verts - a) @ nrm
        if side.max() > 1e-9 and side.min() < -1e-9:
            continue
        key = tuple(np.nonzero(np.abs(side) <= 1e-9)[0])
        if key not in faces:
            faces[key] = nrm if (a - center) @ nrm > 0 else -nrm
    lines = ["solid hull"]
    for key, nrm in faces.items():
        pts = verts[list(key)]
        fc = pts.mean(axis=0)
        # order the face's points by angle around its centroid
        u = pts[0] - fc
        u = u / np.linalg.norm(u)
        w = np.cross(nrm, u)
        order = np.argsort(np.arctan2((pts - fc) @ w, (pts - fc) @ u))
        poly = pts[order]
        for t in range(1, len(poly) - 1):
            lines.append("  facet normal %r %r %r" % tuple(float(x) for x in nrm))
            lines.append("    outer loop")
            for p in (poly[0], poly[t], poly[t + 1]):
                lines.append("      vertex %r %r %r" % tuple(float(x) for x in p))
            lines.append("    endloop")
            lines.append("  endfacet")
    lines.append("endsolid hull")
    return "\n".join(lines) + "\n"


def write(directory: str, hand_only: bool = False) -> str:
    """Write the link hulls as ASCII STL into `directory` and return the
    MJCF text (mesh paths are absolute).

    `hand_only` writes the hand without the cube and with every geom at
    contype="0" conaffinity="0": a world with no collision pair, whose only
    constraint rows are the joint limits."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    links = _links()
    children: Dict[str, List[Tuple]] = {}
    for link in links:
        children.setdefault(link[1], []).append(link)
    assets = []
    nocollide = ' contype="0" conaffinity="0"' if hand_only else ""

    def body_xml(link, indent):
        name, _, pos, axis, rng, hull_axis, length, radius = link
        verts = _palm() if name == "palm" else _prism(length, radius, hull_axis)
        with open(os.path.join(directory, f"{name}.stl"), "w") as f:
            f.write(_stl(verts))
        assets.append(f'    <mesh name="{name}" file="{name}.stl"/>')
        pad = " " * indent
        damping, armature = (0.5, 0.01) if name in ("wrist", "palm") else (0.1, 0.005)
        out = [
            f'{pad}<body name="{name}" pos="{pos[0]} {pos[1]} {pos[2]}">',
            f'{pad}  <joint name="{_joint_name(name)}" type="hinge" axis="{axis}" '
            f'range="{rng[0]} {rng[1]}" damping="{damping}" armature="{armature}"/>',
            f'{pad}  <geom name="{name}" type="mesh" mesh="{name}" density="1000"{nocollide}/>',
        ]
        for child in children.get(name, []):
            out += body_xml(child, indent + 2)
        out.append(f"{pad}</body>")
        return out

    hand = body_xml(children[None][0], 4)
    parent = {link[0]: link[1] for link in links}
    excludes = [
        f'    <exclude body1="{parent[parent[b]]}" body2="{b}"/>'
        for b in parent if parent[b] is not None and parent[parent[b]] is not None
    ]
    tendons, actuators = [], [
        '    <position name="A_WRJ1" joint="WRJ1" kp="5" ctrlrange="-0.489 0.140"/>',
        '    <position name="A_WRJ0" joint="WRJ0" kp="5" ctrlrange="-0.698 0.489"/>',
    ]
    for f in ("FF", "MF", "RF", "LF"):
        tendons.append(
            f'    <fixed name="T_{f}J1c"><joint joint="{f}J0" coef="1"/>'
            f'<joint joint="{f}J1" coef="1"/></fixed>'
        )
        if f == "LF":
            actuators.append('    <position name="A_LFJ4" joint="LFJ4" kp="1" ctrlrange="0 0.785"/>')
        actuators += [
            f'    <position name="A_{f}J3" joint="{f}J3" kp="1" ctrlrange="-0.349 0.349"/>',
            f'    <position name="A_{f}J2" joint="{f}J2" kp="1" ctrlrange="0 1.571"/>',
            f'    <position name="A_{f}J1" tendon="T_{f}J1c" kp="1" ctrlrange="0 3.142"/>',
        ]
    for j, lo, hi in (("THJ4", -1.047, 1.047), ("THJ3", 0.0, 1.222), ("THJ2", -0.209, 0.209),
                      ("THJ1", -0.524, 0.524), ("THJ0", -1.571, 0.0)):
        actuators.append(f'    <position name="A_{j}" joint="{j}" kp="1" ctrlrange="{lo} {hi}"/>')
    cube_z = HAND_HEIGHT + PALM_HALF[2] + CUBE_HALF + 0.003
    cube = [] if hand_only else [
        f'    <body name="cube" pos="{PALM_HALF[0]} 0 {cube_z}">',
        '      <freejoint name="cube_j"/>',
        f'      <geom name="cube" type="box" size="{CUBE_HALF} {CUBE_HALF} {CUBE_HALF}" density="500"/>',
        "    </body>",
    ]
    return "\n".join([
        "<mujoco>",
        f'  <compiler angle="radian" meshdir="{directory}"/>',
        '  <option timestep="0.002" gravity="0 0 -9.81"/>',
        "  <asset>",
        *assets,
        "  </asset>",
        "  <worldbody>",
        f'    <geom name="floor" type="plane" size="1 1 0.1" pos="0 0 0"{nocollide}/>',
        *hand,
        *cube,
        "  </worldbody>",
        "  <contact>",
        *excludes,
        "  </contact>",
        "  <tendon>",
        *tendons,
        "  </tendon>",
        "  <actuator>",
        *actuators,
        "  </actuator>",
        "</mujoco>",
    ]) + "\n"


def initial_state(arrays, batch: int, seed: int,
                  reach: float = 0.3) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded start states from the snapshot's arrays (`np.load` of
    `SNAPSHOT` or `HAND_SNAPSHOT`): (qpos (B, nq), ctrl (B, nu)), float32.

    Each hinge starts at `reach` times a uniform draw from its range (every
    range holds 0, so at a reach below 1 the draw stays inside it; at 1.1
    about one hinge in eleven starts past a limit, whose row is then live);
    the cube sits 3 mm above the palm at a random yaw and a few mm off the
    palm's centre, so it lands within a few substeps; each control is
    uniform in its range."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(arrays["model.qpos0"], np.float32), (batch, 1))
    jtype = np.asarray(arrays["const.jnt_type"])
    qadr = np.asarray(arrays["const.jnt_qposadr"])
    rng_lim = np.asarray(arrays["model.jnt_range"], np.float64)
    for j in range(len(jtype)):
        if jtype[j] == _HINGE:
            lo, hi = rng_lim[j]
            qpos[:, qadr[j]] = reach * rng.uniform(lo, hi, batch)
        elif jtype[j] == _FREE:
            a = qadr[j]
            qpos[:, a:a + 2] += rng.uniform(-0.004, 0.004, (batch, 2))
            yaw = rng.uniform(-np.pi, np.pi, batch)
            qpos[:, a + 3:a + 7] = np.stack(
                [np.cos(yaw / 2), np.zeros(batch), np.zeros(batch), np.sin(yaw / 2)], axis=1)
    cr = np.asarray(arrays["model.actuator_ctrlrange"], np.float64)
    ctrl = rng.uniform(cr[:, 0], cr[:, 1], (batch, len(cr)))
    return qpos.astype(np.float32), ctrl.astype(np.float32)
