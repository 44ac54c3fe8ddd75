"""The share of legal Rubik's cube states that the full-perpendicular env's
reset leaves, for settings of its stand-in world's piece hinges.

    python tools/rubik_hinge_sweep.py [--batch 32] [--steps 3] [--device cpu] \
        FRICTIONLOSS,ARMATURE [FRICTIONLOSS,ARMATURE ...]

For each setting, every piece hinge of `worlds/rubik_full_like.npz` (the 6
face drivers and the 60 cubelet hinges) gets that frictionloss (N m) and
armature (kg m^2); the env is built on it (its settle), reset at --batch
envs from seed 0 and stepped --steps times with uniform random actions.
A state is legal where its faces soft-aligned and its cubelet matrices
rounded give a legal facelet string (`goals_solver.legal_cubes`). Prints
the legal share after the reset and after the steps, the share on the
palm and the live contacts per env.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from robogym_torch import bridge  # noqa: E402
from robogym_torch.envs.dactyl import cube_env, full_perpendicular, goals_solver  # noqa: E402
from robogym_torch.worlds import rubik_full_like  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("settings", nargs="+", help="FRICTIONLOSS,ARMATURE")
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cpu")
    opts = ap.parse_args()
    with np.load(rubik_full_like.SNAPSHOT) as z:
        arrays = {k: z[k] for k in z.files}
    for setting in opts.settings:
        floss, arm = (float(x) for x in setting.split(","))
        model = bridge.model_from_numpy(arrays, opts.device)
        pieces = int(cube_env.rubik_cube_index(model).cube_rot_dof[-1]) + 1
        fl, ar = model.dof_frictionloss.clone(), model.dof_armature.clone()
        fl[pieces:], ar[pieces:] = floss, arm
        model = model.replace(dof_frictionloss=fl, dof_armature=ar)
        t0 = time.perf_counter()
        env = full_perpendicular.FullPerpendicularEnv(
            full_perpendicular.FullPerpendicularEnvConstants(), model, seed=0)
        state, _ = env.reset(opts.batch)
        at_reset = goals_solver.legal_cubes(env.cubelets, state.physics.qpos).mean()
        on_palm = float(cube_env.is_on_palm(env.cube, state.physics).float().mean())
        gen = torch.Generator(device=model.device).manual_seed(0)
        for _ in range(opts.steps):
            action = torch.rand((opts.batch, 20), generator=gen, device=model.device) * 2 - 1
            state, *_ = env.step(state, action)
        live = float(state.physics.contact.active.sum(1).float().mean())
        after = goals_solver.legal_cubes(env.cubelets, state.physics.qpos).mean()
        print(f"frictionloss {floss:g} N m, armature {arm:g} kg m^2, B={opts.batch}: legal "
              f"after the reset {at_reset:.4f}, after {opts.steps} steps {after:.4f}; "
              f"on the palm after the reset "
              f"{on_palm:.4f}; live contacts per env {live:.2f}; "
              f"{time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
