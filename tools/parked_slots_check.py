"""Compare the parked object slots after a mesh-family env's reset in the
JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python tools/parked_slots_check.py [--batch 4] [--seed 0]
        [mixture] [composer] [chessboard] [table_setting]

Builds each env as `chip_smoke.py` does (`chip_smoke.FAMILY_CONFIGS`: 8
slots, 5 objects in use for the mixture and the composer, so slots 5-7 are
parked) with the JAX package on the stand-ins (the seams of
`tests/test_torch_mesh_family.py`) and the port on the JAX env's compiled
models and settled start, resets both at `--batch` envs on the JAX keys'
draws (`jax.random.split(PRNGKey(seed))`), and prints, per slot, whether
it is in use, its body's height and the largest |qvel| of its six dofs
over the batch in each package, and the largest difference between the
packages. A parked slot that moves in both packages alike is the
reference's behaviour, which the port repeats; one that moves in the port
alone is a fault of the port.
"""

import argparse
import copy
import os
import shutil
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("envs", nargs="*", default=["mixture", "composer"])
    opts = ap.parse_args()
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import importlib

    import jax

    import chip_smoke
    import test_torch_mesh_family as fam
    from robogym_torch import bridge
    from robogym_torch.worlds import rearrange_ycb_like
    from test_torch_mesh import from_jax_start, port_worlds, snapshot_tool

    for name in opts.envs:
        tool = snapshot_tool()
        ycb_dir, extra_xml = tool.family_stand_in(name)
        config = copy.deepcopy(chip_smoke.FAMILY_CONFIGS[name])
        with tempfile.TemporaryDirectory() as root:
            for cfg in config[0].get("object_config", {}).values():
                # the JAX dataset takes no `mesh_names`: its directory holds just those
                names = cfg["args"].pop("mesh_names", None)
                if names is not None:
                    ycb_dir = os.path.join(root, "ycb_kept")
                    for n in names:
                        shutil.copytree(os.path.join(rearrange_ycb_like.MESH_DIR, n),
                                        os.path.join(ycb_dir, n))
            with tool.ycb_stand_in(os.path.join(root, "assets"), ycb_dir, extra_xml):
                jenv = importlib.import_module("robogym_tpu.envs.rearrange." + name).make_env(
                    *config)
        tenv = from_jax_start(importlib.import_module("robogym_torch.envs.rearrange." + name)
                              .make_env(*chip_smoke.FAMILY_CONFIGS[name], device="cpu",
                                        worlds=port_worlds(jenv)), jenv)
        keys = jax.random.split(jax.random.PRNGKey(opts.seed), opts.batch)
        jstate, _ = jax.jit(jax.vmap(jenv.reset))(keys)
        draws = fam.reset_draws(name, jenv, keys)
        tstate, _ = tenv.reset(opts.batch, draws)
        jd, td = bridge.data_to_numpy(jstate.physics), bridge.data_to_numpy(tstate.physics)
        c = tenv.model.const
        bodies = np.asarray(tenv.idx.object_body_ids)
        dof = np.asarray(c.jnt_dofadr)[np.asarray(c.body_jntadr)[bodies]]
        qpa = np.asarray(c.jnt_qposadr)[np.asarray(c.body_jntadr)[bodies]]
        active = tenv._active.cpu().numpy()
        print(f"[{name}] B={opts.batch}, seed {opts.seed}: {int(active.sum())} of {len(active)} "
              f"slots in use; reset through {tenv.constants.stabilize_steps} x "
              f"{tenv.constants.mujoco_substeps} substeps of object settle")
        for o, (a, q) in enumerate(zip(dof, qpa)):
            jv, tv = np.abs(jd["qvel"][:, a:a + 6]), np.abs(td["qvel"][:, a:a + 6])
            diff = np.abs(jd["qvel"][:, a:a + 6] - td["qvel"][:, a:a + 6]).max()
            print(f"  slot {o} ({'in use' if active[o] else 'parked'}): height JAX "
                  f"{np.round(jd['qpos'][:, q + 2], 4).tolist()}, port "
                  f"{np.round(td['qpos'][:, q + 2], 4).tolist()}; largest |qvel| per env JAX "
                  f"{np.round(jv.max(-1), 4).tolist()}, port {np.round(tv.max(-1), 4).tolist()}; "
                  f"largest |qvel| difference {diff:.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
