"""Rubik's-face wrappers (counterpart of `robogym_tpu/wrappers/face.py`;
reference robogym/wrappers/face.py)."""

from __future__ import annotations

from robogym_torch.wrappers.randomizations import RandomizedDampingWrapper


class RandomizedFaceDampingWrapper(RandomizedDampingWrapper):
    """Per-episode loguniform damping on the cube's face driver joints, every
    joint named `<object_name>:cubelet:driver:*` (reference
    wrappers/face.py:4-9; the JAX package takes an env's
    `face_joint_names` first, which no ported env has)."""

    def __init__(self, env=None, damping_range=(1 / 3.0, 3.0), object_name="cube"):
        prefix = f"{object_name}:cubelet:driver:"
        names = [n for n in env.model.const.names["joint"] if n.startswith(prefix)]
        super().__init__(env, damping_range, names)
