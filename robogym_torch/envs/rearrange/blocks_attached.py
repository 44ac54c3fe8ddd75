"""The attached-blocks env: 8 blocks whose goal is a tight plus-shaped
pattern (`AttachedBlockStateGoal`), its slots shuffled over the blocks and
the pattern placed at random in the placement area. Counterpart of
`robogym_tpu/envs/rearrange/blocks_attached.py`."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from robogym_torch.envs.core import uniform_apply
from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.envs.rearrange import goals as goals_lib
from robogym_torch.mjcf.model import Model

# the pattern in block-size units (attached_block_state.py:36-48):
#       [ ][ ]
#    [ ][ ][ ][ ]
#       [ ][ ]
BLOCK_CONFIG = np.array([[1, 0], [2, 0], [0, 1], [1, 1], [2, 1], [3, 1], [1, 2], [2, 2]],
                        np.float64)


class AttachedBlockStateGoal(goals_lib.ObjectStateGoal):
    """The pattern's slots permuted over the objects (`perm` (B, O)) and
    its origin uniform where it fits in the placement area (`off_u`
    (B, 2)); every object on the table, unrotated."""

    def draw(self, gen, B, num_objects_used, device=None):
        return {"perm": self._perm(gen, B, device), "off_u": self._u(gen, device, B, 2)}

    def next_goal(self, draws, active_mask, object_size, num_objects_used, d):
        O = self.idx.max_num_objects
        dev = active_mask.device
        lo, hi, table_h = self._bounds(num_objects_used, dev)
        size = object_size[..., 0].to(self.dtype).amax(-1)[..., None, None]   # half-extent
        cfg = torch.as_tensor(BLOCK_CONFIG[:O], dtype=self.dtype, device=dev) * 2.0 * size
        cfg = self._take(cfg.expand(draws["perm"].shape + (2,)), draws["perm"])
        span = cfg.amax(1)
        lo_xy = lo[:2] + size[..., 0, :]
        origin = uniform_apply(draws["off_u"], lo_xy, torch.maximum(hi[:2] - span - size[..., 0, :],
                                                                    lo_xy))
        pos = self._on_table(origin[:, None, :] + cfg, object_size, table_h, active_mask)
        quat = torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=self.dtype, device=dev)
        return {"obj_pos": pos, "obj_rot": quat.expand(pos.shape[:2] + (4,)).clone(),
                "goal_valid": torch.ones(pos.shape[0], dtype=torch.bool, device=dev)}


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             device="cuda", seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> blocks_lib.BlocksRearrangeEnv:
    cst, par = blocks_lib.configs(constants, parameters, num_objects=8, max_num_objects=8)
    env = blocks_lib.BlocksRearrangeEnv(cst, par, seed=seed,
                                        **(worlds or blocks_lib.load_worlds(cst, par, device)))
    env.goal_gen = AttachedBlockStateGoal(env.idx, goals_lib.GoalArgs(),
                                          par.simulation_params.used_table_portion, env.dtype)
    return env
