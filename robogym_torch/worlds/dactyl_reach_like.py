"""A hand-only world with the names and pose that dactyl/reach binds to.

The reference builds the reach world from the Shadow Hand, floor and
target assets (`robogym_tpu/envs/dactyl/reach.py:46-67`); none of them is
part of this repository, so this module writes a stand-in that both
packages' reach env binds to (`reach.py:73-106`,
`robogym_tpu/robot/shadow_hand.py:20-103`):

  * the hand of `dactyl_locked_like.py` (the same convex-hull links, box
    palm, 24 hinges, 20 position actuators and four J1+J0 tendons, every
    name under `robot0:`), inside a body `robot0:hand_mount` at the
    reference's mount pose, pos (1.0, 1.25, 0.15) and euler (pi/2, 0, pi).
    The stand-in's links are laid out in other axes than the real hand's,
    so inside the mount a fixed body `robot0:hand_frame` turns them by pi
    about x: the fingers then point along -x at about 0.19 m over the
    floor, the palm faces -y and the thumb points up. Unturned, the thumb
    would start 3 cm under the floor;
  * each actuator force-limited (`forcerange`, in N m) at the real hand's
    limits, so that effort control (`shadow_hand.effort_control_model`)
    has limits to scale its [-1, 1] command by. The effort model also
    limits its control to [-1, 1], and both packages clamp the control to
    that range before the force limit, so where a limit is above 1 (the
    wrist's 4.785 and 2.175, THJ4's 2.3722 and THJ3's 1.45) a command
    above 1 / limit comes back from `actuator_effort` clipped to it;
  * no cube and no target cube: the reach env has neither;
  * five target sites `target:S_fftip` .. `target:S_thtip` on a fixed body
    `target`, which collide with nothing (a site has no geometry);
  * a floor plane on a body `floor` at (1, 1, 0).

nq = nv = 24, nu = 20.

Pure Python and numpy: `write(directory)` writes the hand's STL files and
returns the MJCF text. The compiled model ships as `dactyl_reach_like.npz`
next to this file (see `tools/build_locked_like_snapshot.py`, which
compiles it as the reach env compiles its world: plain `compile_xml`, the
default contact budgets).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from robogym_torch.worlds import dactyl_locked_like

SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "dactyl_reach_like.npz")
MOUNT_POS = (1.0, 1.25, 0.15)
MOUNT_EULER = (np.pi / 2, 0.0, np.pi)
FLOOR_POS = (1.0, 1.0, 0.0)
# each actuator's force limit (N m): the real hand's
FORCE_LIMITS = {
    "A_WRJ1": 4.785, "A_WRJ0": 2.175,
    "A_FFJ3": 0.9, "A_FFJ2": 0.9, "A_FFJ1": 0.7245,
    "A_MFJ3": 0.9, "A_MFJ2": 0.9, "A_MFJ1": 0.7245,
    "A_RFJ3": 0.9, "A_RFJ2": 0.9, "A_RFJ1": 0.7245,
    "A_LFJ4": 0.9, "A_LFJ3": 0.9, "A_LFJ2": 0.9, "A_LFJ1": 0.7245,
    "A_THJ4": 2.3722, "A_THJ3": 1.45, "A_THJ2": 0.99, "A_THJ1": 0.99, "A_THJ0": 0.81,
}
# the target sites: markers in front of the fingers, over the floor
_TARGETS = (("S_fftip", (0.78, 1.48, 0.2)), ("S_mftip", (0.78, 1.48, 0.18)),
            ("S_rftip", (0.78, 1.48, 0.16)), ("S_lftip", (0.79, 1.48, 0.14)),
            ("S_thtip", (0.95, 1.48, 0.33)))


def _force_limited(line: str) -> str:
    """An actuator line of `hand_parts` with its force limit added."""
    name = line.split('name="')[1].split('"')[0][len(dactyl_locked_like.PREFIX):]
    f = FORCE_LIMITS[name]
    return line.replace("/>", f' forcelimited="true" forcerange="{-f} {f}"/>')


def write(directory: str) -> str:
    """Write the hand's link hulls as ASCII STL into `directory` and return
    the MJCF text (mesh paths are absolute)."""
    hand = dactyl_locked_like.hand_parts(directory)
    p, e = MOUNT_POS, MOUNT_EULER
    bodies: List[str] = [
        f'    <body name="{dactyl_locked_like.PREFIX}hand_mount" pos="{p[0]} {p[1]} {p[2]}" '
        f'euler="{e[0]!r} {e[1]!r} {e[2]!r}">',
        f'      <body name="{dactyl_locked_like.PREFIX}hand_frame" euler="{np.pi!r} 0 0">',
        *["    " + line for line in hand["bodies"]],
        "      </body>",
        "    </body>",
    ]
    hand = dict(hand, bodies=bodies, actuators=[_force_limited(a) for a in hand["actuators"]])
    targets = ['    <body name="target" pos="0 0 0">',
               *[f'      <site name="target:{s}" pos="{q[0]} {q[1]} {q[2]}" size="0.005"/>'
                 for s, q in _TARGETS],
               "    </body>"]
    f = FLOOR_POS
    floor = (f'    <body name="floor" pos="{f[0]} {f[1]} {f[2]}">\n'
             '      <geom name="floor" type="plane" size="1 1 0.1"/>\n'
             "    </body>")
    return dactyl_locked_like.assemble(directory, hand, targets, floor=floor)
