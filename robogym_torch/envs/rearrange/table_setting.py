"""The table-setting rearrange env (robogym's
envs/rearrange/table_setting.py): five tableware meshes, a plate, two
forks, a knife and a spoon, at fixed scales and colours, with a goal that
lays them out as a table setting.

Counterpart of `robogym_tpu/envs/rearrange/table_setting.py`. Slot i
always holds `SLOT_MESHES[i]` at `SLOT_SCALES[i]`: its hull scaled, its
mass by scale^3 and its principal inertia by scale^5 (the bank's are at
unit scale and density 1000); its colour `SLOT_COLORS[i]`, each object a
group of its own. The goal is `goals.ObjectFixedStateGoal` at
`RELATIVE_PLACEMENTS` of the placement area, the spoon turned by 0.38 rad
about z.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.envs.rearrange import goals as goals_lib
from robogym_torch.envs.rearrange import mesh as mesh_lib
from robogym_torch.mjcf.model import Model
from robogym_torch.worlds import rearrange_mesh_family_like

MESH_NAMES = ["029_plate", "030_fork", "031_spoon", "032_knife"]
SLOT_MESHES = ["029_plate", "030_fork", "030_fork", "032_knife", "031_spoon"]
SLOT_SCALES = [0.6, 0.53, 0.53, 0.6, 0.63]
SLOT_COLORS = [[0.99, 0.44, 0.35, 1.0]] + [[0.506, 0.675, 0.75, 1.0]] * 4
RELATIVE_PLACEMENTS = np.array([[0.6, 0.5], [0.6, 0.68], [0.6, 0.75], [0.6, 0.36], [0.6, 0.28]])
SPOON_YAW = 0.38


def init_quats(n: int) -> np.ndarray:
    """(n, 4) the goal's rotations: identity, the fifth slot's (the spoon)
    SPOON_YAW about z."""
    quats = np.tile(np.asarray([[1.0, 0.0, 0.0, 0.0]]), (n, 1))
    if n >= 5:
        quats[4] = [np.cos(SPOON_YAW / 2), 0.0, 0.0, np.sin(SPOON_YAW / 2)]
    return quats


class TableSettingRearrangeEnv(mesh_lib.MeshRearrangeEnv):
    """The mesh env with each slot's fixed candidate (module docstring)."""

    def draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        """The blocks env's reset draws: no candidate, no group is drawn."""
        return blocks_lib.BlocksRearrangeEnv.draw_reset(self, n)

    def _reset_model_fields(self, draws: Dict[str, torch.Tensor], batch: int):
        """(table_setting.py:29-71): (fields, half-sizes (B, O, 3), group ids
        (B, O), each object its own)."""
        O, bank, dev = self.max_num_objects, self.bank, self.device
        index = {n: i for i, n in enumerate(bank.names)}
        cand = torch.as_tensor([index[n] for n in SLOT_MESHES[:O]], device=dev)
        scales = torch.as_tensor(SLOT_SCALES[:O], dtype=self.dtype, device=dev)[:, None]
        colors = torch.as_tensor(SLOT_COLORS[:O], dtype=self.dtype, device=dev)
        mids, bids, gids = self._slot_ids()
        sizes = bank.bbox_half[cand] * scales
        s = scales[:, 0]
        s2 = s * s          # scale^3 and scale^5 multiplied out as XLA's integer powers are

        def per_env(field, rows, values):
            return self._per_env(field, rows, values.expand((batch,) + values.shape), batch)

        fields = {
            "mesh_convex_vert": per_env("mesh_convex_vert", mids,
                                        bank.hull_vert[cand] * scales[:, None, :]),
            "mesh_convex_mask": per_env("mesh_convex_mask", mids, bank.hull_mask[cand]),
            "body_mass": per_env("body_mass", bids, bank.mass[cand] * (s * s2)),
            "body_inertia": per_env("body_inertia", bids,
                                    bank.inertia[cand] * (s * (s2 * s2))[:, None]),
            "body_iquat": per_env("body_iquat", bids, bank.iquat[cand]),
            "body_ipos": per_env("body_ipos", bids, torch.zeros((O, 3), device=dev)),
            "geom_size": per_env("geom_size", gids, sizes),
            "geom_rgba": per_env("geom_rgba", gids, colors),
        }
        return (fields, sizes.expand((batch,) + sizes.shape),
                torch.arange(O, device=dev).expand(batch, O))


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             mesh_files_by_name: Optional[Dict[str, List[str]]] = None, device="cuda",
             seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> TableSettingRearrangeEnv:
    """The table-setting env on `device` (the card unless the caller asks
    for the CPU), as the JAX package's `make_env(constants, parameters)`
    builds it (5 objects in 5 slots by default): the bank of
    `mesh_files_by_name` (by default the stand-in tableware of
    `rearrange_mesh_family_like.TABLEWARE_DIR`) kept to `MESH_NAMES`, on
    the compiled `worlds` (by default the stand-in's table-setting world)."""
    cst, par = blocks_lib.configs(constants, parameters,
                                  constants_cls=functools.partial(
                                      mesh_lib.MeshRearrangeEnvConstants, normalize_mesh=True),
                                  num_objects=5, max_num_objects=5)
    files = dict(mesh_files_by_name if mesh_files_by_name is not None
                 else mesh_lib.find_meshes_by_dirname(rearrange_mesh_family_like.TABLEWARE_DIR))
    files = {k: v for k, v in files.items() if k in MESH_NAMES}
    bank = mesh_lib.MeshObjectBank.build(files, normalized_mesh_size=cst.normalized_mesh_size)
    worlds = worlds or blocks_lib.load_worlds(
        cst, par, device, main=rearrange_mesh_family_like.SNAPSHOTS["table_setting"])
    worlds = {k: v for k, v in worlds.items() if k != "settle_model"}
    env = TableSettingRearrangeEnv(cst, par, bank=bank, seed=seed, **worlds)
    O = par.simulation_params.max_num_objects
    env.goal_gen = goals_lib.ObjectFixedStateGoal(
        env.idx, goals_lib.GoalArgs(), par.simulation_params.used_table_portion, env.dtype,
        relative_placements=RELATIVE_PLACEMENTS[:O], init_quats=init_quats(O))
    return env
