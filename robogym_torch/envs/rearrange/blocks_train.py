"""The blocks training env, batched: the blocks env with the "train" goals
(`goals.TrainStateGoal`: goal-distance ratio, pick-up and stacking goals)
and, under `use_cuboid`, each episode's blocks scaled per axis.

Counterpart of `robogym_tpu/envs/rearrange/blocks_train.py`. The scales are
exp-uniform in [-object_scale_low, object_scale_high) per group and axis
(duplicates stay identical), drawn as `scale_u` (B, O, 3) in `draw_reset`;
they reach the physics as each env's `geom_size`, `body_mass` (times the
volume scale) and `body_inertia` (a box's) model fields. The goal settle
under `stabilize_goal` keeps the compiled block sizes, as the JAX
package's does.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from robogym_torch.envs.core import uniform_apply
from robogym_torch.envs.rearrange import blocks as blocks_lib
from robogym_torch.mjcf.model import Model


@dataclasses.dataclass(frozen=True)
class BlockTrainEnvConstants(blocks_lib.RearrangeEnvConstants):
    goal_generation: str = "train"
    use_cuboid: bool = False


@dataclasses.dataclass(frozen=True)
class BlockTrainEnvParameters(blocks_lib.RearrangeEnvParameters):
    # exp-uniform per-axis scale range (common/base.py:203-204)
    object_scale_low: float = 0.0
    object_scale_high: float = 0.0


class BlockTrainRearrangeEnv(blocks_lib.BlocksRearrangeEnv):
    def draw_reset(self, n: int) -> Dict[str, torch.Tensor]:
        out = super().draw_reset(n)
        if self.constants.use_cuboid:
            out["scale_u"] = self._u(n, self.max_num_objects, 3)
        return out

    def _reset_model_fields(self, draws, batch):
        """The colours, and under `use_cuboid` each episode's block sizes,
        masses and inertias (blocks_train.py:34-66)."""
        fields, sizes, group_ids = super()._reset_model_fields(draws, batch)
        if not self.constants.use_cuboid:
            return fields, sizes, group_ids
        par, O = self.parameters, self.max_num_objects
        group_scales = torch.exp(uniform_apply(draws["scale_u"], -par.object_scale_low,
                                               par.object_scale_high))
        scales = torch.gather(group_scales, 1,
                              torch.clamp(group_ids, 0, O - 1)[..., None].expand(-1, -1, 3))
        new_sizes = sizes * scales
        vol_scale = torch.prod(scales, dim=-1)
        gids = torch.as_tensor(self.idx.object_geom_ids, device=self.device)
        bids = torch.as_tensor(self.idx.object_body_ids, device=self.device)

        def per_env(x):
            return x.expand((batch,) + tuple(x.shape)).clone()

        geom_size, body_mass = per_env(self.model.geom_size), per_env(self.model.body_mass)
        body_inertia = per_env(self.model.body_inertia)
        geom_size[:, gids] = new_sizes
        body_mass[:, bids] = body_mass[:, bids] * vol_scale
        # a box's inertia: m / 3 (b^2 + c^2) about each axis
        s2 = new_sizes ** 2
        base_m = self.model.body_mass[bids] * vol_scale
        body_inertia[:, bids] = torch.stack([base_m / 3.0 * (s2[..., 1] + s2[..., 2]),
                                             base_m / 3.0 * (s2[..., 0] + s2[..., 2]),
                                             base_m / 3.0 * (s2[..., 0] + s2[..., 1])], dim=-1)
        fields.update(geom_size=geom_size, body_mass=body_mass, body_inertia=body_inertia)
        return fields, new_sizes, group_ids


def make_env(constants: Optional[dict] = None, parameters: Optional[dict] = None,
             device="cuda", seed: int = 0, worlds: Optional[Dict[str, Model]] = None
             ) -> BlockTrainRearrangeEnv:
    """The blocks training env, as `blocks.make_env` builds the blocks env."""
    cst, par = blocks_lib.configs(constants, parameters, BlockTrainEnvConstants,
                                  BlockTrainEnvParameters)
    return BlockTrainRearrangeEnv(cst, par, seed=seed,
                                  **(worlds or blocks_lib.load_worlds(cst, par, device)))
