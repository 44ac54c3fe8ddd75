"""The word-blocks env: six letter blocks ("OPENAI") in one group,
wood-coloured or, under `rainbow_mode`, one rainbow colour each, whose goal
is a fixed row (`goals.ObjectFixedStateGoal`) with the A and I blocks
turned 0.38 rad about z; the world `rearrange_wordblocks_like` (6 blocks).
Counterpart of `robogym_tpu/envs/rearrange/wordblocks.py`; like it, the
blocks carry colours, not letter textures."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.envs.rearrange import goals as goals_lib
from robogym_torch.mjcf.model import Model
from robogym_torch.worlds import rearrange_blocks_like

RAINBOW = [[1.0, 0.0, 0.0, 1.0], [1.0, 0.647, 0.0, 1.0], [1.0, 1.0, 0.0, 1.0],
           [0.0, 0.502, 0.0, 1.0], [0.0, 0.0, 1.0, 1.0], [0.294, 0.0, 0.51, 1.0]]
WOOD = [[0.702, 0.522, 0.212, 1.0]] * 6
TILT = 0.38                       # the A and I blocks' goal rotation about z (rad)


@dataclasses.dataclass(frozen=True)
class WordBlocksEnvConstants(blocks_lib.RearrangeEnvConstants):
    rainbow_mode: bool = False


class WordBlocksEnv(blocks_lib.BlocksRearrangeEnv):
    def sample_object_groups(self, lam_u, gumbel, color_u):
        B, O = color_u.shape[:2]
        colors = torch.as_tensor((RAINBOW if self.constants.rainbow_mode else WOOD) * O,
                                 dtype=self.dtype, device=color_u.device)[:O]
        return (torch.zeros((B, O), dtype=torch.long, device=color_u.device),
                colors.expand(B, O, 4).clone())


def goal_generator(idx, used_table_portion: float = 1.0,
                   dtype=torch.float32) -> goals_lib.ObjectFixedStateGoal:
    """The fixed row (wordblocks.py:52-60): x from 0.2 to 0.8 of the
    placement area, y at its middle, blocks 4 and 5 (A, I) tilted."""
    O = idx.max_num_objects
    rel = np.stack([np.linspace(0.2, 0.8, O), np.full(O, 0.5)], axis=1)
    quats = np.tile(np.asarray([[1.0, 0.0, 0.0, 0.0]]), (O, 1))
    quats[4:6] = [np.cos(TILT / 2), 0.0, 0.0, np.sin(TILT / 2)]
    return goals_lib.ObjectFixedStateGoal(idx, goals_lib.GoalArgs(), used_table_portion, dtype,
                                          relative_placements=rel, init_quats=quats)


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             device="cuda", seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> WordBlocksEnv:
    n = rearrange_blocks_like.WORDBLOCKS_OBJECTS
    cst, par = blocks_lib.configs(constants, parameters, WordBlocksEnvConstants, num_objects=n,
                                  max_num_objects=n)
    worlds = worlds or blocks_lib.load_worlds(cst, par, device,
                                              rearrange_blocks_like.WORDBLOCKS_SNAPSHOT)
    env = WordBlocksEnv(cst, par, seed=seed, **worlds)
    env.goal_gen = goal_generator(env.idx, par.simulation_params.used_table_portion, env.dtype)
    return env
