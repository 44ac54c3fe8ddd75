"""Parametric transforms (counterpart of `robogym_tpu/wrappers/parametric.py`;
reference robogym/wrappers/parametric.py): an env parameter that only
changes model arrays becomes a per-episode model transform."""

from __future__ import annotations

import numpy as np

from robogym_torch.envs.core import uniform_apply
from robogym_torch.wrappers.core import Transform
from robogym_torch.wrappers.randomizations import _ix, rand


class RandomizedPerpendicularCubeSizeWrapper(Transform):
    """The perpendicular (cubelet) cube's size scaled by one
    U[cube_size_range] draw an episode (reference parametric.py:24-38):
    every `<object_name>:cubelet*` geom's size and body's position."""

    model_fields = ("geom_size", "body_pos")

    def __init__(self, env=None, cube_size_range=(0.95, 1.05), object_name="cube"):
        self.cube_size_range = tuple(cube_size_range)
        prefix = f"{object_name}:cubelet"
        c = env.model.const
        self.geom_ids = np.asarray(sorted(i for n, i in c.names["geom"].items()
                                          if n.startswith(prefix)), np.int64)
        self.body_ids = np.asarray(sorted(i for n, i in c.names["body"].items()
                                          if n.startswith(prefix)), np.int64)
        if not len(self.geom_ids):
            raise ValueError(f"no '{prefix}' geoms in this model")

    def draw_model(self, gen, batch, env):
        return {"u": rand(gen, (batch,), env)}

    def model(self, tstate, fields, draws):
        scale = uniform_apply(draws["u"], *self.cube_size_range)[:, None, None]
        gs = fields["geom_size"].clone()
        g = _ix(self.geom_ids, gs.device)
        gs[:, g] = gs[:, g] * scale
        fields = dict(fields, geom_size=gs)
        if len(self.body_ids):
            bp = fields["body_pos"].clone()
            b = _ix(self.body_ids, bp.device)
            bp[:, b] = bp[:, b] * scale
            fields["body_pos"] = bp
        return fields
