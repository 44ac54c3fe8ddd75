"""A holdout rearrange task's stand-in: a ball on a fixed platform and a
cylinder standing on the table of `rearrange_blocks_like`.

robogym's holdout configs and their object XMLs and saved states are not
part of this repository, so this directory holds a stand-in in their
shape:
  * `ball_like.jsonnet`: `make_env.function`
    (`robogym.envs.rearrange.holdout:make_env`) and its `args`: two task
    objects (`task_object_configs`, one each of `xmls/ball.xml`, a sphere of
    radius 0.03 m, and `xmls/cylinder.xml`, a cylinder of radius 0.03 m and
    half-length 0.04 m, density 500, each with `tag_args`), one scene object
    (`scene_object_configs`: `xmls/platform.xml`, a fixed body at (0.15,
    0.15, 0.41) whose geom is `PLATFORM_STL`, a 32-sided slab of radius
    0.09 m and 0.02 m high: 64 hull verts, its top 0.02 m above the table's),
    the success threshold, `initial_state_path` and
    `goal_args.goal_state_paths`;
  * `states/initial_state_ball_like.npz` and `states/goal_state_ball_like.npz`
    (`obj_pos` (2, 3), `obj_quat` (2, 4)): at rest, the ball on the platform
    and the cylinder upright on the table (`INITIAL`); in the goal, both
    moved along the table (`GOAL`);
  * `holdout_ball_like.npz` beside this directory: the world compiled by
    `tools/build_locked_like_snapshot.py holdout_ball_like` as the JAX
    holdout env's `_compile_world` builds it (`robogym_tpu/envs/rearrange/
    holdout.py:150-179`): `rearrange_blocks_like.write(directory, 0)` with
    the task objects `object0` (the ball) and `object1` (the cylinder) and
    the scene body `scene0_0`, and `scale_contact_budgets(model, 2, 1)`.

At rest the ball against the platform is a sphere-mesh pair and the
cylinder against the table a cylinder-box pair: both are convex pairs with
a round geom, which the collision driver's round branch collides.
"""

import os

import numpy as np

DIR = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(DIR, "ball_like.jsonnet")
XML_DIR = os.path.join(DIR, "xmls")
STATE_DIR = os.path.join(DIR, "states")
PLATFORM_STL = os.path.join(DIR, "holdout_platform.stl")
SNAPSHOT = os.path.join(os.path.dirname(DIR), "holdout_ball_like.npz")
# object poses (position, quaternion) of the ball and the cylinder
INITIAL = ((0.15, 0.15, 0.45), (-0.15, -0.1, 0.44))
GOAL = ((0.2, -0.15, 0.43), (-0.05, 0.2, 0.44))


def platform_verts() -> np.ndarray:
    """The platform's 64 hull points, about its body's origin."""
    ang = np.arange(32) * (np.pi / 16)
    ring = np.stack([0.09 * np.cos(ang), 0.09 * np.sin(ang)], axis=1)
    return np.concatenate([np.concatenate([ring, np.full((32, 1), z)], axis=1)
                           for z in (-0.01, 0.01)])


def write_files(directory: str = DIR) -> None:
    """Write the platform's STL and the two saved states (`states/`) into
    `directory`."""
    from robogym_torch.worlds import locked_like

    os.makedirs(os.path.join(directory, "states"), exist_ok=True)
    with open(os.path.join(directory, os.path.basename(PLATFORM_STL)), "w") as f:
        f.write(locked_like._stl(platform_verts()))
    quat = np.tile([1.0, 0.0, 0.0, 0.0], (2, 1))
    for name, pos in (("initial_state", INITIAL), ("goal_state", GOAL)):
        np.savez(os.path.join(directory, "states", f"{name}_ball_like.npz"),
                 obj_pos=np.asarray(pos), obj_quat=quat)
