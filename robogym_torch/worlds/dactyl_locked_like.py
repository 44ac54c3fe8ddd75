"""A hand-and-cube world with the names and structure dactyl/locked binds to.

The Shadow Hand and cube assets are not part of this repository, so this
module writes a stand-in that both packages' env code binds to
(`robogym_tpu/envs/dactyl/cube_env.py:80-157`,
`robogym_tpu/robot/shadow_hand.py:20-103`):

  * the hand of `locked_like.py` (the same convex-hull links, 24 hinges, 20
    position actuators, four J1+J0 tendons), every name under the
    `robot0:` prefix, with the fingertip sites `robot0:S_fftip` to
    `robot0:S_thtip` and the phasespace sites `robot0:phasespace_ref0..2`
    on the palm; the palm is a box, so that palm and cube form a box-box
    pair (kernel E), as dactyl/locked's do;
  * the cube `cube:` on three slides `cube:cube_tx/ty/tz` and a ball
    `cube:cube_rot`, its box geom `cube:middle` (the name the cube-size
    randomization looks for), with a `cube:center` site, resting on the
    palm;
  * the target cube `target:` on the same four joints, its geom at
    contype="0" conaffinity="0" (it collides with nothing). Its slides
    carry a spring (stiffness 50 N/m to their rest position) and a damper
    (5 N s/m): gravity alone would let it fall for the whole episode, as
    nothing in the env sets its state; the spring holds it about 1.8 cm
    below the cube's start, at rest. Its ball joint is free and nothing
    turns it;
  * a floor plane.

nq = 24 + 7 + 7 = 38, nv = 24 + 6 + 6 = 36, as in dactyl/locked.

Pure Python and numpy: `write(directory)` writes the STL files and returns
the MJCF text. The compiled model ships as `dactyl_locked_like.npz` next to
this file (see `tools/build_locked_like_snapshot.py`); `initial_state`
draws seeded start states.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

from robogym_torch.worlds import locked_like

PREFIX = "robot0:"
CUBE_HALF = locked_like.CUBE_HALF
PALM_HALF = locked_like.PALM_HALF
HAND_HEIGHT = locked_like.HAND_HEIGHT
SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dactyl_locked_like.npz")

_HINGE = 3
# fingertip site of each distal link, at its hull's far end
_TIPS = {"FFdistal": ("S_fftip", (0.024, 0.0, 0.0)), "MFdistal": ("S_mftip", (0.024, 0.0, 0.0)),
         "RFdistal": ("S_rftip", (0.024, 0.0, 0.0)), "LFdistal": ("S_lftip", (0.022, 0.0, 0.0)),
         "THdistal": ("S_thtip", (0.0, 0.027, 0.0))}
# the phasespace reference sites on the palm's underside: origin ref1, ref0
# along the fingers, ref2 across the palm
_REFS = (("phasespace_ref0", (0.09, 0.0, -0.01)), ("phasespace_ref1", (0.0, 0.0, -0.01)),
         ("phasespace_ref2", (0.0, 0.045, -0.01)))


def _cube(prefix: str, pos, target: bool) -> List[str]:
    h = CUBE_HALF
    slide = ' stiffness="50" damping="5"' if target else ""
    geom = ' contype="0" conaffinity="0" group="2"' if target else ""
    out = [f'    <body name="{prefix}middle" pos="{pos[0]} {pos[1]} {pos[2]}">']
    for ax, axis in zip("xyz", ("1 0 0", "0 1 0", "0 0 1")):
        out.append(f'      <joint name="{prefix}cube_t{ax}" type="slide" axis="{axis}"{slide}/>')
    out += [
        f'      <joint name="{prefix}cube_rot" type="ball"/>',
        f'      <geom name="{prefix}middle" type="box" size="{h} {h} {h}" density="500"{geom}/>',
        f'      <site name="{prefix}center" pos="0 0 0"/>',
        "    </body>",
    ]
    return out


def hand_parts(directory: str) -> Dict[str, List[str]]:
    """Write the link hulls as ASCII STL into `directory` and return the
    hand's MJCF pieces, each a list of lines: its mesh `assets`, its
    `bodies` (under the worldbody), the `excludes` of each link and its
    grandparent, its `tendons` and its `actuators`."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    links = locked_like._links()
    children: Dict[str, List[Tuple]] = {}
    for link in links:
        children.setdefault(link[1], []).append(link)
    assets = []
    P = PREFIX

    def body_xml(link, indent):
        name, _, pos, axis, rng, hull_axis, length, radius = link
        pad = " " * indent
        damping, armature = (0.5, 0.01) if name in ("wrist", "palm") else (0.1, 0.005)
        out = [
            f'{pad}<body name="{P}{name}" pos="{pos[0]} {pos[1]} {pos[2]}">',
            f'{pad}  <joint name="{P}{locked_like._joint_name(name)}" type="hinge" axis="{axis}" '
            f'range="{rng[0]} {rng[1]}" damping="{damping}" armature="{armature}"/>',
        ]
        if name == "palm":
            hx, hy, hz = PALM_HALF
            out.append(f'{pad}  <geom name="{P}palm" type="box" pos="{hx} 0 0" '
                       f'size="{hx} {hy} {hz}" density="1000"/>')
            out += [f'{pad}  <site name="{P}{s}" pos="{p[0]} {p[1]} {p[2]}"/>' for s, p in _REFS]
        else:
            with open(os.path.join(directory, f"{name}.stl"), "w") as f:
                f.write(locked_like._stl(locked_like._prism(length, radius, hull_axis)))
            assets.append(f'    <mesh name="{P}{name}" file="{name}.stl"/>')
            out.append(f'{pad}  <geom name="{P}{name}" type="mesh" mesh="{P}{name}" '
                       f'density="1000"/>')
        if name in _TIPS:
            s, p = _TIPS[name]
            out.append(f'{pad}  <site name="{P}{s}" pos="{p[0]} {p[1]} {p[2]}"/>')
        for child in children.get(name, []):
            out += body_xml(child, indent + 2)
        out.append(f"{pad}</body>")
        return out

    bodies = body_xml(children[None][0], 4)
    parent = {link[0]: link[1] for link in links}
    excludes = [
        f'    <exclude body1="{P}{parent[parent[b]]}" body2="{P}{b}"/>'
        for b in parent if parent[b] is not None and parent[parent[b]] is not None
    ]
    tendons, actuators = [], [
        f'    <position name="{P}A_WRJ1" joint="{P}WRJ1" kp="5" ctrlrange="-0.489 0.140"/>',
        f'    <position name="{P}A_WRJ0" joint="{P}WRJ0" kp="5" ctrlrange="-0.698 0.489"/>',
    ]
    for f in ("FF", "MF", "RF", "LF"):
        tendons.append(
            f'    <fixed name="{P}T_{f}J1c"><joint joint="{P}{f}J0" coef="1"/>'
            f'<joint joint="{P}{f}J1" coef="1"/></fixed>'
        )
        if f == "LF":
            actuators.append(f'    <position name="{P}A_LFJ4" joint="{P}LFJ4" kp="1" '
                             'ctrlrange="0 0.785"/>')
        actuators += [
            f'    <position name="{P}A_{f}J3" joint="{P}{f}J3" kp="1" ctrlrange="-0.349 0.349"/>',
            f'    <position name="{P}A_{f}J2" joint="{P}{f}J2" kp="1" ctrlrange="0 1.571"/>',
            f'    <position name="{P}A_{f}J1" tendon="{P}T_{f}J1c" kp="1" ctrlrange="0 3.142"/>',
        ]
    for j, lo, hi in (("THJ4", -1.047, 1.047), ("THJ3", 0.0, 1.222), ("THJ2", -0.209, 0.209),
                      ("THJ1", -0.524, 0.524), ("THJ0", -1.571, 0.0)):
        actuators.append(f'    <position name="{P}A_{j}" joint="{P}{j}" kp="1" '
                         f'ctrlrange="{lo} {hi}"/>')
    return dict(assets=assets, bodies=bodies, excludes=excludes, tendons=tendons,
                actuators=actuators)


FLOOR = '    <geom name="floor" type="plane" size="1 1 0.1" pos="0 0 0"/>'


def assemble(directory: str, hand: Dict[str, List[str]], objects: List[str],
             equality: List[str] = (), floor: str = FLOOR) -> str:
    """The MJCF text of a world: the `floor` lines (a plane at the origin
    by default), the hand's pieces, the `objects` lines under the
    worldbody and the `equality` lines."""
    return "\n".join([
        "<mujoco>",
        f'  <compiler angle="radian" meshdir="{os.path.abspath(directory)}"/>',
        '  <option timestep="0.002" gravity="0 0 -9.81"/>',
        "  <asset>",
        *hand["assets"],
        "  </asset>",
        "  <worldbody>",
        floor,
        *hand["bodies"],
        *objects,
        "  </worldbody>",
        "  <contact>",
        *hand["excludes"],
        "  </contact>",
        *(["  <equality>", *equality, "  </equality>"] if equality else []),
        "  <tendon>",
        *hand["tendons"],
        "  </tendon>",
        "  <actuator>",
        *hand["actuators"],
        "  </actuator>",
        "</mujoco>",
    ]) + "\n"


# the cube's rest position on the palm
CUBE_POS = (PALM_HALF[0], 0.0, HAND_HEIGHT + PALM_HALF[2] + CUBE_HALF + 0.003)


def write(directory: str) -> str:
    """Write the link hulls as ASCII STL into `directory` and return the
    MJCF text (mesh paths are absolute)."""
    return assemble(directory, hand_parts(directory),
                    _cube("cube:", CUBE_POS, target=False) + _cube("target:", CUBE_POS,
                                                                   target=True))


def initial_state(arrays, batch: int, seed: int,
                  reach: float = 0.3) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded start states from the snapshot's arrays (`np.load` of
    `SNAPSHOT`): (qpos (B, nq), ctrl (B, nu)), float32, as
    `locked_like.initial_state` draws them: each hinge at `reach` times a
    uniform draw from its range, the cube a few mm off its rest position
    at a random yaw, the target at rest, each control uniform in its
    range."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(arrays["model.qpos0"], np.float32), (batch, 1))
    jtype = np.asarray(arrays["const.jnt_type"])
    qadr = np.asarray(arrays["const.jnt_qposadr"])
    rng_lim = np.asarray(arrays["model.jnt_range"], np.float64)
    names = json.loads(str(arrays["const.names"]))["joint"]
    for j in range(len(jtype)):
        if jtype[j] == _HINGE:
            lo, hi = rng_lim[j]
            qpos[:, qadr[j]] = reach * rng.uniform(lo, hi, batch)
    a = [qadr[names[f"cube:cube_t{ax}"]] for ax in "xy"]
    qpos[:, a] += rng.uniform(-0.004, 0.004, (batch, 2))
    r = qadr[names["cube:cube_rot"]]
    yaw = rng.uniform(-np.pi, np.pi, batch)
    qpos[:, r:r + 4] = np.stack(
        [np.cos(yaw / 2), np.zeros(batch), np.zeros(batch), np.sin(yaw / 2)], axis=1)
    cr = np.asarray(arrays["model.actuator_ctrlrange"], np.float64)
    ctrl = rng.uniform(cr[:, 0], cr[:, 1], (batch, len(cr)))
    return qpos.astype(np.float32), ctrl.astype(np.float32)
