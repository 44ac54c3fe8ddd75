"""Author a holdout's saved states from the command line: load a holdout
config (or any rearrange env), settle it with zero actions on a batch of
one env, and save the objects' poses as `initial_state_<ts>.npz` or
`goal_state_<ts>.npz` in the reference's format (`obj_pos` (O, 3),
`obj_quat` (O, 4)), which the holdout env's `initial_state_path` and
`goal_state_paths` read back.

Counterpart of `robogym_tpu/scripts/create_holdout.py` (robogym's
scripts/create_holdout.py and viewer/holdout_creation_viewer.py:13-100).
Other `key=value` arguments go to the env's factory (`constants`,
`parameters`, `device`: the card unless the caller asks for the CPU).

Usage:
    python -m robogym_torch.scripts.create_holdout <config.jsonnet> \\
        out_dir=holdout_states [kind=initial|goal] [settle_steps=20] [seed=0]
"""

from __future__ import annotations

import datetime
import os
import sys

import numpy as np
import torch

from robogym_torch.utils.env_utils import load_env
from robogym_torch.utils.parse_arguments import parse_arguments


def save_state(env, state, out_dir: str, kind: str = "initial") -> str:
    """Save the objects' poses of the batch's one env in the reference's
    npz format (holdout_creation_viewer.py:55-71): its path."""
    from robogym_torch.envs.rearrange import simulation as sim_lib

    os.makedirs(out_dir, exist_ok=True)
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    path = os.path.join(out_dir, f"{kind}_state_{ts}.npz")
    np.savez(
        path,
        obj_pos=sim_lib.object_positions(env.idx, state.physics)[0].cpu().numpy(),
        obj_quat=sim_lib.object_quats(env.idx, state.physics)[0].cpu().numpy(),
    )
    return path


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    names, kwargs = parse_arguments(argv)
    if not names:
        raise SystemExit("usage: create_holdout.py <env pattern> out_dir=...")
    pattern = names[0]
    out_dir = kwargs.pop("out_dir", ".")
    kind = kwargs.pop("kind", "initial")
    settle_steps = int(kwargs.pop("settle_steps", 20))
    seed = int(kwargs.pop("seed", 0))

    env = load_env(pattern, seed=seed, **kwargs)
    state, obs = env.reset(1)
    zero = torch.zeros((1, env.action_size), dtype=env.dtype, device=env.device)
    for _ in range(settle_steps):
        state, obs, reward, done, info = env.step(state, zero)
    path = save_state(env, state, out_dir, kind)
    print(f"saved {kind} state to {path}")


if __name__ == "__main__":
    main()
