"""The blocks pick-and-place env: the first block's goal in the air
(`goals.PickAndPlaceGoal`). Counterpart of
`robogym_tpu/envs/rearrange/blocks_pickandplace.py`."""

from typing import Dict, Optional

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.mjcf.model import Model


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             device="cuda", seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> blocks_lib.BlocksRearrangeEnv:
    cst = {"goal_generation": "pickandplace", **(constants or {})}
    return blocks_lib.make_env(cst, parameters, device, seed, worlds)
