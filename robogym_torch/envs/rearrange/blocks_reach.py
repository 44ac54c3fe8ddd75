"""The blocks reach env: the TCP must reach the one block's goal position
(`goals.ObjectReachGoal`); `goal_generation="det-state"` takes the
deterministic pool of two positions (`goals.DeterministicReachGoal`).
Counterpart of `robogym_tpu/envs/rearrange/blocks_reach.py`."""

from typing import Dict, Optional

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.mjcf.model import Model


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             device="cuda", seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> blocks_lib.BlocksRearrangeEnv:
    cst = dict(constants or {})
    gen = cst.pop("goal_generation", "state")
    cst["goal_generation"] = "det-reach" if gen == "det-state" else "reach"
    par = dict(parameters or {})
    par["simulation_params"] = {"num_objects": 1, **par.get("simulation_params", {})}
    return blocks_lib.make_env(cst, par, device, seed, worlds)
