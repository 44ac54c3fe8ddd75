"""The duplicate-blocks env: every block in one group, of one colour (its
draw `color_u[:, 0]`), so goals match blocks greedily. Counterpart of
`robogym_tpu/envs/rearrange/blocks_duplicate.py`."""

from typing import Dict, Optional

import torch

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.mjcf.model import Model


class DuplicateBlockRearrangeEnv(blocks_lib.BlocksRearrangeEnv):
    def sample_object_groups(self, lam_u, gumbel, color_u):
        B, O = color_u.shape[:2]
        color = torch.cat([color_u[:, 0], torch.ones_like(color_u[:, 0, :1])], dim=-1)
        return (torch.zeros((B, O), dtype=torch.long, device=color_u.device),
                color[:, None].expand(B, O, 4).clone())


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             device="cuda", seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> DuplicateBlockRearrangeEnv:
    cst, par = blocks_lib.configs(constants, parameters)
    return DuplicateBlockRearrangeEnv(cst, par, seed=seed,
                                      **(worlds or blocks_lib.load_worlds(cst, par, device)))
