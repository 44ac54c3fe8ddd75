"""Replay a rearrange env's reset substep by substep and find the envs
whose physics turns non-finite.

    python3 tools/env_nan_probe.py --env table_setting [--batch 1024]
        [--device cuda] [--out build/nan_probe.npz]
        [--world NPZ --meshes DIR]
    JAX_PLATFORMS=cpu python tools/env_nan_probe.py --replay FILE [--substeps 200]

Builds `robogym_torch.envs.rearrange.<env>.make_env()` with seed 0, draws
its reset as `chip_smoke.py` does (`env.draw_reset(batch)`, the first
draws from the env's generator), and repeats the reset's steps by hand:
each env's model fields, the placement, the objects posed, then the
object settle (`stabilize_steps` x `mujoco_substeps` substeps) one
substep at a time, checking qpos and qvel finite per env. Prints the first
substep with a non-finite env, those envs, and each env's largest |qvel|
over the settle; saves the posed start state of those envs and their
model fields (`bridge.data_to_numpy` keys, `fields.<name>`), the
substep, and the port's model (`model.<...>`, `bridge.model_to_numpy`),
so that a CPU run can step the same start through the JAX package.
`--world` and `--meshes` build the env on another compiled main world
(a snapshot) and bank (a mesh directory). Then the reset itself runs, and
the share of envs with every object on the table and finite is printed.

`--replay FILE` (on the CPU, where the JAX package runs) steps the saved
envs' start states through the JAX package's step under `jax.vmap` and
through the port's, each with the saved per-env fields, and prints each
package's first non-finite substep and the envs' largest |qvel|.
"""

import argparse
import importlib
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, REPO)
    from robogym_torch import bridge
    from robogym_torch.envs import core
    from robogym_torch.envs.rearrange import goals, simulation
    from robogym_torch.physics import step

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--env", default="table_setting")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "nan_probe.npz"))
    ap.add_argument("--world", help="the main world's snapshot")
    ap.add_argument("--meshes", help="the bank's mesh directory")
    ap.add_argument("--replay", help="a saved probe to step through both packages (CPU)")
    ap.add_argument("--substeps", type=int, default=200)
    opts = ap.parse_args()
    if opts.replay:
        return replay(opts.replay, opts.substeps)

    kw = {}
    if opts.world:
        from robogym_torch.envs.rearrange import blocks
        from robogym_torch.envs.rearrange.mesh import find_meshes_by_dirname
        from robogym_torch.worlds import rearrange_blocks_like

        kw["worlds"] = {"model": blocks._load(opts.world, opts.device),
                        "solver_model": blocks._load(rearrange_blocks_like.SOLVER_SNAPSHOT,
                                                     opts.device)}
        if opts.meshes:
            kw["mesh_files_by_name"] = find_meshes_by_dirname(opts.meshes)
    env = importlib.import_module("robogym_torch.envs.rearrange." + opts.env).make_env(
        device=opts.device, seed=0, **kw)
    B, O = opts.batch, env.max_num_objects
    draws = env.draw_reset(B)
    fields, sizes, _ = env._reset_model_fields(draws, B)
    d = core.data_map(lambda x: x.expand((B,) + x.shape[1:]).clone(), env._initial_data)
    pos, _ = goals.sample_goal_positions(draws["place_u"], env.idx, env._active, sizes,
                                         env.num_objects,
                                         env.parameters.simulation_params.used_table_portion)
    quat = goals.sample_goal_rotations(draws["place_rot_u"], B, O,
                                       goals.GoalArgs(randomize_goal_rot=True), env.dtype,
                                       env.device)
    start = simulation.set_object_poses(env.idx, d, pos, quat)
    m = core.apply_model_fields(env.model, fields)
    n_sub = env.constants.stabilize_steps * env.constants.mujoco_substeps
    d, first, bad = start, None, None
    vmax = torch.zeros(B, device=start.qpos.device)
    for i in range(n_sub):
        d = step.step(m, d)
        ok = torch.isfinite(d.qpos).all(-1) & torch.isfinite(d.qvel).all(-1)
        vmax = torch.maximum(vmax, torch.where(ok, d.qvel.abs().amax(-1),
                                               torch.full_like(vmax, float("inf"))))
        if first is None and not bool(ok.all()):
            first, bad = i, torch.nonzero(~ok).flatten()
    top = torch.argsort(vmax, descending=True)[:8]
    print(f"[probe] {opts.env} at B={B}: {n_sub} settle substeps; first non-finite substep "
          f"{first}, envs {None if bad is None else bad.tolist()}; largest |qvel| over the "
          f"settle, envs {top.tolist()}: {[float(v) for v in vmax[top]]}")
    envs = bad if bad is not None else top[:1]
    out = {k: v for k, v in bridge.data_to_numpy(
        core.data_map(lambda x: x[envs], start)).items()}
    out.update({"fields." + k: v[envs].detach().cpu().numpy() for k, v in fields.items()})
    out.update({"model." + k if not k.startswith(("model.", "const.", "opt.")) else k: v
                for k, v in bridge.model_to_numpy(env.model).items()})
    out["envs"] = envs.cpu().numpy()
    out["first_substep"] = np.asarray(-1 if first is None else first)
    os.makedirs(os.path.dirname(os.path.abspath(opts.out)), exist_ok=True)
    np.savez_compressed(opts.out, **out)
    print(f"[probe] saved {opts.out}")
    if opts.world:
        state, _ = env.reset(B)
        pos = simulation.object_positions(env.idx, state.physics)
        off = simulation.check_objects_off_table(env.idx, pos, active_mask=env._active).any(-1)
        finite = torch.isfinite(state.physics.qpos).all(-1) & torch.isfinite(
            state.physics.qvel).all(-1)
        obj = torch.as_tensor(np.concatenate([np.arange(a, a + 6) for a in (
            env.model.const.jnt_dofadr[env.model.const.body_jntadr[env.idx.object_body_ids]])]),
            device=state.physics.qvel.device)
        v = state.physics.qvel[:, obj].abs().amax(-1)
        print(f"[probe] {opts.env} reset at B={B}: finite {float(finite.float().mean()):.4f}, "
              f"every object on the table {float((~off).float().mean()):.4f}; objects' |qvel| "
              f"median {float(v.median()):.3g}, above 1 in {int((v > 1).sum())} envs, max "
              f"{float(v.max()):.3g}")
    return 0


def replay(path: str, substeps: int) -> int:
    """Step a saved probe's envs through the JAX package and the port."""
    sys.path.insert(0, os.path.join(REPO, "tests"))
    import jax
    import jax.numpy as jnp

    from _torch_common import jax_data_from_numpy, jax_model_from_numpy
    from robogym_torch import bridge
    from robogym_torch.envs import core
    from robogym_torch.physics import step as t_step
    from robogym_tpu.envs import core as j_core
    from robogym_tpu.physics import setconst as j_setconst
    from robogym_tpu.physics import step as j_step

    z = dict(np.load(path))
    model = {k: v for k, v in z.items() if k.startswith(("model.", "const.", "opt."))}
    fields = {k[len("fields."):]: v for k, v in z.items() if k.startswith("fields.")}
    data = {k: v for k, v in z.items() if k not in model and not k.startswith("fields.")
            and k not in ("envs", "first_substep")}
    jm = jax_model_from_numpy(model)
    j_setconst.invweight0(jm)
    jstep = jax.jit(jax.vmap(lambda mf, x: j_step.step(j_core.apply_model_fields(jm, mf), x)))
    mf = {k: jnp.asarray(v) for k, v in fields.items()}
    tm = core.apply_model_fields(bridge.model_from_numpy(model, "cpu"),
                                 {k: torch.as_tensor(v) for k, v in fields.items()})
    jd, td = jax_data_from_numpy(data), bridge.data_from_numpy(data, "cpu")
    n = len(z["envs"])
    vmax = {"jax": np.zeros(n), "port": np.zeros(n)}
    first = {"jax": None, "port": None}
    for i in range(substeps):
        jd, td = jstep(mf, jd), t_step.step(tm, td)
        for name, q in (("jax", np.asarray(jd.qvel)), ("port", td.qvel.numpy())):
            fin = np.isfinite(q).all(-1)
            vmax[name] = np.maximum(vmax[name], np.where(fin, np.abs(q).max(-1), np.inf))
            if first[name] is None and not fin.all():
                first[name] = i
    print(f"[replay] envs {z['envs'].tolist()} of {path}, {substeps} substeps from the posed "
          f"start: first non-finite substep JAX {first['jax']}, port {first['port']}; largest "
          f"|qvel| JAX {vmax['jax'].tolist()}, port {vmax['port'].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
