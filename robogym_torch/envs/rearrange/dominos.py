"""The dominos env: blocks of domino proportions (0.2, 1, 2 times
`object_size`, the world `rearrange_dominos_like`); goals follow the
training goals with the mod-180 rotation distance, or under `is_holdout`
stand along an arc (`goals.DominoStateGoal`). Counterpart of
`robogym_tpu/envs/rearrange/dominos.py`."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.envs.rearrange import goals as goals_lib
from robogym_torch.envs.rearrange import simulation as sim_lib
from robogym_torch.mjcf.compiler import compile_xml
from robogym_torch.mjcf.model import Model
from robogym_torch.worlds import rearrange_blocks_like


@dataclasses.dataclass(frozen=True)
class DominosEnvConstants(blocks_lib.RearrangeEnvConstants):
    is_holdout: bool = False
    goal_args: tuple = (("rot_dist_type", "mod180"),)


class DominosRearrangeEnv(blocks_lib.BlocksRearrangeEnv):
    @property
    def block_half_size(self) -> np.ndarray:
        return self.parameters.simulation_params.object_size * \
            rearrange_blocks_like.DOMINO_PROPORTIONS

    @staticmethod
    def _compile_world(constants, parameters, device,
                       build_world_xml=sim_lib.build_blocks_world_xml) -> Model:
        """The dominos env's main world (dominos.py `_compile_world`): the
        world with no blocks plus `max_num_objects` blocks of half-size
        `object_size * DOMINO_PROPORTIONS`, with that many objects' contact
        budgets."""
        sp = parameters.simulation_params
        xml = build_world_xml(0, robot_control_params=parameters.robot_control_params,
                              mujoco_timestep=constants.mujoco_timestep)
        for i in range(sp.max_num_objects):
            xml.append(sim_lib.make_block_xml(
                f"object{i}", sp.object_size * rearrange_blocks_like.DOMINO_PROPORTIONS))
        model = compile_xml(xml, device=device)
        return sim_lib.scale_contact_budgets(model, sp.max_num_objects)


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             device="cuda", seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> DominosRearrangeEnv:
    cst, par = blocks_lib.configs(constants, parameters, DominosEnvConstants)
    worlds = worlds or blocks_lib.load_worlds(cst, par, device,
                                              rearrange_blocks_like.DOMINOS_SNAPSHOT)
    env = DominosRearrangeEnv(cst, par, seed=seed, **worlds)
    sp, gargs = par.simulation_params, goals_lib.GoalArgs(**dict(cst.goal_args))
    if cst.is_holdout:
        env.goal_gen = goals_lib.DominoStateGoal(env.idx, gargs, sp.used_table_portion, env.dtype)
    else:
        env.goal_gen = goals_lib.TrainStateGoal(env.idx, gargs, sp.used_table_portion, env.dtype,
                                                goal_distance_ratio=sp.goal_distance_ratio)
    return env
