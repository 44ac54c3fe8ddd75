"""The goal-settle world of rearrange/blocks with 5 objects.

Under `stabilize_goal` the JAX package's blocks env steps an objects-only
copy of its world every env step (`envs/rearrange/simulation.py`
`build_settle_world_xml`, stepped in `envs/rearrange/blocks.py`
`_stabilize_goal`): the floor, the table and the free blocks, with no arm,
no actuators and no tendons. Its blocks are boxes of half-size 0.0254 m and
density 1000 (`make_block_xml`) and its timestep is 1 ms.

The table comes from the UR16e assets, which are not part of this
repository, so this module writes a stand-in: a static box table of
half-size 0.4 x 0.4 x 0.2 m (0.8 x 0.8 m top, 0.4 m high) on the floor
plane. Pairs: 15 box-box (5 block-table, 10 block-block) and 5
plane-box; the two static geoms do not collide with each other.

Pure Python and numpy: `write()` returns the MJCF text. The compiled model,
with the contact budgets that `scale_contact_budgets(model, 5)` gives it,
ships as `blocks_settle_like.npz` next to this file (see
`tools/build_locked_like_snapshot.py`); `initial_state` draws seeded start
states for it.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

N_BLOCKS = 5
BLOCK_HALF = 0.0254
TABLE_HALF = (0.4, 0.4, 0.2)
TABLE_TOP = 2 * TABLE_HALF[2]
SNAPSHOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "blocks_settle_like.npz")

_FREE = 0
_GRID = 4            # start cells per side on the table top
_CELL = 0.1          # m between cell centres: blocks at any yaw cannot touch
_JITTER = 0.01       # m


def write() -> str:
    """The MJCF text of the world."""
    blocks = []
    for i in range(N_BLOCKS):
        blocks += [
            f'    <body name="object{i}" pos="0 0 0">',
            f'      <geom name="object{i}" type="box" size="{BLOCK_HALF} {BLOCK_HALF} {BLOCK_HALF}" '
            'density="1000"/>',
            f'      <joint name="object{i}:joint" type="free"/>',
            "    </body>",
        ]
    hx, hy, hz = TABLE_HALF
    return "\n".join([
        "<mujoco>",
        '  <compiler angle="radian" coordinate="local"/>',
        '  <option timestep="0.001" gravity="0 0 -9.81"/>',
        "  <worldbody>",
        '    <geom name="floor" type="plane" size="2 2 0.1" pos="0 0 0"/>',
        f'    <body name="table" pos="0 0 {hz}">',
        f'      <geom name="table" type="box" size="{hx} {hy} {hz}"/>',
        "    </body>",
        *blocks,
        "  </worldbody>",
        "</mujoco>",
    ]) + "\n"


def initial_state(arrays, batch: int, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """Seeded start states from the snapshot's arrays (`np.load` of
    `SNAPSHOT`): (qpos (B, nq), ctrl (B, 0)), float32.

    Each block sits 1 to 5 mm above the table top at a random yaw, in its
    own cell of a 4 x 4 grid of 0.1 m cells around the table's centre,
    jittered by up to 1 cm, so no two blocks touch. In every other env
    (the odd ones) block 1 starts on block 0 instead, 1 to 5 mm above it and
    up to 5 mm off its centre, as a stack goal places it, so block-block
    pairs are live."""
    rng = np.random.default_rng(seed)
    qpos = np.tile(np.asarray(arrays["model.qpos0"], np.float64), (batch, 1))
    jtype = np.asarray(arrays["const.jnt_type"])
    adr = np.asarray(arrays["const.jnt_qposadr"])[jtype == _FREE]
    n = len(adr)
    cells = np.argsort(rng.random((batch, _GRID * _GRID)), axis=1)[:, :n]
    centre = (np.arange(_GRID) - (_GRID - 1) / 2) * _CELL
    xy = np.stack([centre[cells // _GRID], centre[cells % _GRID]], axis=-1)
    xy += rng.uniform(-_JITTER, _JITTER, xy.shape)
    z = TABLE_TOP + BLOCK_HALF + rng.uniform(0.001, 0.005, (batch, n))
    stacked = np.arange(batch) % 2 == 1
    xy[stacked, 1] = xy[stacked, 0] + rng.uniform(-0.005, 0.005, (int(stacked.sum()), 2))
    z[stacked, 1] = z[stacked, 0] + 2 * BLOCK_HALF + rng.uniform(0.001, 0.005, int(stacked.sum()))
    yaw = rng.uniform(-np.pi, np.pi, (batch, n))
    for k, a in enumerate(adr):
        qpos[:, a:a + 2] = xy[:, k]
        qpos[:, a + 2] = z[:, k]
        qpos[:, a + 3:a + 7] = np.stack([np.cos(yaw[:, k] / 2), np.zeros(batch), np.zeros(batch),
                                         np.sin(yaw[:, k] / 2)], axis=1)
    ctrl = np.zeros((batch, 0), np.float32)
    return qpos.astype(np.float32), ctrl
