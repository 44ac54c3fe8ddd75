"""The block stacking env: a tower over a random base (`goals.ObjectStackGoal`,
in a random order unless `stack_fixed_order`), 2 blocks by default.
Counterpart of `robogym_tpu/envs/rearrange/blocks_stack.py`."""

from typing import Dict, Optional

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.mjcf.model import Model


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             device="cuda", seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> blocks_lib.BlocksRearrangeEnv:
    cst = {"goal_generation": "stack", **(constants or {})}
    par = dict(parameters or {})
    par["simulation_params"] = {"num_objects": 2, **par.get("simulation_params", {})}
    return blocks_lib.make_env(cst, par, device, seed, worlds)
