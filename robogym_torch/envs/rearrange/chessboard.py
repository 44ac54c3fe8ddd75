"""The chessboard rearrange env (robogym's envs/rearrange/chessboard.py):
four chess pieces, normalised to 0.03 m, with a goal that lines them up as
a back rank.

Counterpart of `robogym_tpu/envs/rearrange/chessboard.py`: the mesh env
over the pieces `PIECES`, each episode drawing its pieces with
replacement, and `goals.ObjectFixedStateGoal` at x = 0.35 of the placement
area and y evenly from 0.25 to 0.75. The reference paints a chessboard on
the table; the JAX package leaves that texture out, and so does the port.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.envs.rearrange import goals as goals_lib
from robogym_torch.envs.rearrange import mesh as mesh_lib
from robogym_torch.mjcf.model import Model
from robogym_torch.worlds import rearrange_mesh_family_like

PIECES = ["rook", "knight", "bishop", "queen"]


class ChessboardRearrangeEnv(mesh_lib.MeshRearrangeEnv):
    """The mesh env over the chess pieces."""


def back_rank(n: int) -> np.ndarray:
    """(n, 2) the goal's fractions of the placement area."""
    return np.stack([np.full(n, 0.35), np.linspace(0.25, 0.75, n)], axis=1)


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             mesh_files_by_name: Optional[Dict[str, List[str]]] = None, device="cuda",
             seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> ChessboardRearrangeEnv:
    """The chessboard env on `device` (the card unless the caller asks for
    the CPU), as the JAX package's `make_env(constants, parameters)` builds
    it (4 pieces in 4 slots by default): the bank of `mesh_files_by_name`
    (by default the stand-in pieces of `rearrange_mesh_family_like.CHESS_DIR`)
    kept to `PIECES`, on the compiled `worlds` (by default the stand-in's
    chessboard world)."""
    cst, par = blocks_lib.configs(constants, parameters,
                                  constants_cls=functools.partial(
                                      mesh_lib.MeshRearrangeEnvConstants, normalize_mesh=True,
                                      normalized_mesh_size=0.03),
                                  num_objects=4, max_num_objects=4)
    files = dict(mesh_files_by_name if mesh_files_by_name is not None
                 else mesh_lib.find_meshes_by_dirname(rearrange_mesh_family_like.CHESS_DIR))
    files = {k: v for k, v in files.items() if k in PIECES}
    bank = mesh_lib.MeshObjectBank.build(files, normalized_mesh_size=cst.normalized_mesh_size)
    worlds = worlds or blocks_lib.load_worlds(
        cst, par, device, main=rearrange_mesh_family_like.SNAPSHOTS["chessboard"])
    worlds = {k: v for k, v in worlds.items() if k != "settle_model"}
    env = ChessboardRearrangeEnv(cst, par, bank=bank, seed=seed, **worlds)
    env.goal_gen = goals_lib.ObjectFixedStateGoal(
        env.idx, goals_lib.GoalArgs(), par.simulation_params.used_table_portion, env.dtype,
        relative_placements=back_rank(par.simulation_params.max_num_objects))
    return env
