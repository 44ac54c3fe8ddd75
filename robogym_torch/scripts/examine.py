"""Examine an env from the command line: load it by name fragment, `.py`
path or `.json` / `.jsonnet` config, run it with random actions on a
batch of one env, and print a line each step.

Counterpart of `robogym_tpu/scripts/examine.py` (robogym's
scripts/examine.py). A card has no window, so the default is a textual
trace; `record=PATH` saves the qpos trajectory, (T + 1, nq), to an `.npz`
that `viewer.replay_npz` renders; `interactive=True` runs the curses
viewer (`viewer/interactive.py`) and `teleop=True` the stdin teleop.
Other `key=value` arguments go to the env's factory (`constants`,
`parameters`, `device`: the card unless the caller asks for the CPU).

Usage:
    python -m robogym_torch.scripts.examine dactyl/locked.py num_steps=20
    python -m robogym_torch.scripts.examine rearrange/blocks.py \\
        constants='@{"mujoco_substeps": 10}' record=traj.npz
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from robogym_torch.utils.env_utils import load_env
from robogym_torch.utils.parse_arguments import parse_arguments
from robogym_torch.viewer.replay import uniform_actions


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    names, kwargs = parse_arguments(argv)
    if not names:
        raise SystemExit("usage: examine.py <env pattern> [key=value ...]")
    pattern = names[0]

    num_steps = int(kwargs.pop("num_steps", 20))
    seed = int(kwargs.pop("seed", 0))
    record = kwargs.pop("record", None)
    teleop = bool(kwargs.pop("teleop", False))
    interactive = bool(kwargs.pop("interactive", False))

    env = load_env(pattern, seed=seed, **kwargs)
    print(f"Loaded env {type(env).__name__} (action_size={env.action_size})")

    if interactive:
        # the curses live loop (the EnvViewer / RobotControlViewer analogue)
        from robogym_torch.viewer.interactive import InteractiveViewer

        return InteractiveViewer(env, seed=seed, teleop=teleop).run()
    if teleop:
        return _teleop_loop(env, seed, record)

    env.generator.manual_seed(seed)
    state, obs = env.reset(1)
    print("observation keys:", sorted(obs.keys()))

    gen = torch.Generator(device=env.device)
    gen.manual_seed(seed + 1)
    traj = [state.physics.qpos[0].cpu().numpy()]
    for t in range(num_steps):
        state, obs, reward, done, info = env.step(state, uniform_actions(env, gen))
        traj.append(state.physics.qpos[0].cpu().numpy())
        r = reward[0].cpu().numpy()
        ended = bool(done[0])
        successes = info.get("successes_so_far")
        successes = 0 if successes is None else int(successes.reshape(-1)[0])
        print(f"t={t:4d} reward={np.array2string(r, precision=3)} done={ended} "
              f"successes={successes}")
        if ended:
            print("episode done; resetting")
            state, obs = env.reset(1)

    if record:
        np.savez(record, qpos=np.stack(traj))
        print(f"saved {len(traj)}-frame qpos trajectory to {record}")


def _teleop_loop(env, seed: int, record):
    """The stdin teleop (robot_control_viewer.py:44-107, typed commands in
    place of GLFW keys): up/down/left/right, z+/z-, wrist+/wrist-,
    grip+/grip-, +/- (speed), q (quit); an empty line steps with zero
    control."""
    from robogym_torch.robot.teleop import URGripperArmController

    ctl = URGripperArmController(env)
    env.generator.manual_seed(seed)
    state, obs = env.reset(1)
    traj = [state.physics.qpos[0].cpu().numpy()]
    print("teleop: " + " ".join(sorted(ctl.KEYMAP)) + " | +/- speed | q quit")
    while True:
        try:
            cmd = input("> ").strip()
        except EOFError:
            break
        if cmd == "q":
            break
        try:
            action = ctl.action_for(cmd) if cmd else ctl.zero_control()
        except KeyError:
            print(f"unknown command {cmd!r}")
            continue
        action = torch.as_tensor(np.asarray(action), dtype=env.dtype,
                                 device=env.device).reshape(1, -1)
        state, obs, reward, done, info = env.step(state, action)
        traj.append(state.physics.qpos[0].cpu().numpy())
        print(f"reward={np.array2string(reward[0].cpu().numpy(), precision=3)} "
              f"done={bool(done[0])}")
    if record:
        np.savez(record, qpos=np.stack(traj))
        print(f"saved {len(traj)}-frame qpos trajectory to {record}")


if __name__ == "__main__":
    main()
