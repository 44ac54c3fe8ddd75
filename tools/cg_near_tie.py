#!/usr/bin/env python3
"""Find the envs where kernel B leaves its plain version, and show the line
search there.

    python3 tools/cg_near_tie.py [--world settle|locked_like|table|table_setting|
                                          chessboard|mixture|composer] [--seed N]
                                 [--capture step|path] [--earliest] [--trajectory N]

Runs on an NVIDIA GPU. It captures kernel B's inputs from one substep of a
world at B=1024 as `chip_smoke.py` does (start states from `--seed`, by
default chip_smoke.py's; for a mesh-family env, the main sim's last
substep of its path, `make_env`, reset and `FAMILY_STEPS` steps, or with
`--capture step` of one env step from the reset, where `chip_smoke.py`
takes B's inputs), runs the kernel and the plain version for 1 to
15 CG iterations, and finds the envs whose qacc after some iteration
differs from the plain version's by more than `chip_smoke.CG_EARLY_TOL`
of the batch's largest |qacc|. For each (the ten
furthest off after 15 iterations) it prints the first such iteration and
the line search there: the plain version's costs dcost(a) = a c1 + a^2 c2 /
2 + pen(a) - pen(0) of the four steps a = a1 x (2, 1, 0.5, 0.125), in
float32 and in a float64 run on the same inputs, the step each picks (the
least cost below 0, else 0), and the step the kernel took there (its move
along the plain version's search direction). Two picks that differ where
two costs lie within float32's rounding of each other are a near-tie of
the discrete line search, not a fault of the kernel. `--earliest` lists
the ten envs that leave the plain version first instead.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def traced_plain(chip_smoke, args):
    """`cg_full_plain` on `args` with the line search of each iteration
    recorded (`cg_kernel.cg_plain`'s trace)."""
    from robogym_torch.physics import cg_kernel

    trace = []
    cg_kernel.cg_full_plain(*args, solve=functools.partial(cg_kernel.cg_plain, trace=trace))
    return trace


def family_core(chip_smoke, name, seed, capture):
    """Kernel B's inputs from a mesh-family env's reset state at B=1024:
    the main sim's last substep of one env step (`capture` "step", where
    `chip_smoke.py` holds B) or of its path's `FAMILY_STEPS` steps ("path")."""
    import importlib

    from robogym_torch.physics import constraint_batched

    make_env = importlib.import_module("robogym_torch.envs.rearrange." + name).make_env
    env = make_env(*chip_smoke.FAMILY_CONFIGS[name], device="cuda", seed=seed)
    state, _ = env.reset(chip_smoke.BATCH)
    if capture == "step":
        return chip_smoke.capture_rearrange(env, state, ())["main"]
    last = {}
    with chip_smoke.patched([((constraint_batched, "fused_step_core"),
                              lambda *a, fn=constraint_batched.fused_step_core:
                              last.update(args=a) or fn(*a))]):
        chip_smoke.family_path(name, env, state, {}, [])
    kind_s, its, nfacet, *args = last["args"]
    return constraint_batched.core_inputs(kind_s, nfacet, *args), its, nfacet


def trajectories(chip_smoke, ci, its, nfacet, n, envs=()):
    """For n envs that `chip_smoke.tie_reference` does not excuse (or the
    envs `envs`, excused or not): at each
    iteration k, each output's departure from the forced plain version
    (relative to the batch's largest entry), the kernel's step along the
    plain version's direction over the plain version's step, the closest
    line-search alternative's cost gap over its tie bound, and the row
    nearest its state's edge (|jar| over its bound, for rows with Done > 0;
    the friction-loss edge for rows with Dfr > 0)."""
    from robogym_torch.physics import cg_kernel

    def args_of(k):
        return chip_smoke.cg_args(ci, k, nfacet)

    force, excused, unexcused = chip_smoke.tie_reference("cg_full", args_of, its)
    print(f"[trajectory] {len({e for e, _, _ in excused})} envs excused, {len(unexcused)} not")
    outs = chip_smoke.KERNELS["cg_full"]["outputs"]
    got = [cg_kernel.cg_full(*args_of(k)) for k in range(its + 1)]
    want = [chip_smoke.forced_plain("cg_full", args_of(k), force) for k in range(its + 1)]
    rows = chip_smoke.row_weights("cg_full", args_of(its))
    named = {e: (k, why) for e, k, why in unexcused}
    named.update({e: (k, "excused on a tie at") for e, k, _ in excused if e in envs})
    for env, (k0, why) in ([(e, named.get(e, (0, "does not leave"))) for e in envs] if envs
                           else [(e, (k, w)) for e, k, w in unexcused[:n]]):
        one = [env]
        trace = []
        B = got[0][0].shape[0]
        chip_smoke.forced_plain("cg_full", chip_smoke.take_envs(args_of(its), one, B),
                                force.take(one), trace)
        print(f"  env {env}: {why} after {k0}")
        for k in range(1, its + 1):
            dev = ", ".join(f"{o} {float((g[env] - w[env]).abs().max() / w.abs().max()):.2e}"
                            for o, g, w in zip(outs, got[k], want[k]))
            t = trace[k - 1]
            p = t["p"][0]
            step = got[k][0][env] - got[k - 1][0][env]
            a_k = float((step * p).sum() / (p * p).sum().clamp_min(1e-30))
            a_p = float(t["step"][0])
            cost = torch.cat([t["dcost"][0].double(), torch.zeros(1, device=p.device,
                                                                  dtype=torch.float64)])
            bnd = torch.cat([chip_smoke.tie_bound(t["mag"][0].double()),
                             torch.zeros(1, device=p.device, dtype=torch.float64)])
            r = int(t["pick"][0])
            gaps = [float((cost[j] - cost[r]).abs() / (bnd[j] + bnd[r]).clamp_min(1e-300))
                    for j in range(5) if j != r]
            jar = t["jar"][0].double()
            jb = chip_smoke.tie_bound(t["jmag"][0].double())
            Deq, Done, Dfr, floss = (x[env].double() for x in rows)
            neg_r = torch.where(Done > 0, jar.abs() / jb, torch.full_like(jar, float("inf")))
            fr_r = torch.where(Dfr > 0, ((Dfr * jar).abs() - floss).abs()
                               / chip_smoke.tie_bound(Dfr * t["jmag"][0].double() + floss),
                               torch.full_like(jar, float("inf")))
            print(f"    it {k:2d}: {dev}; step kernel/plain {a_k:.6g}/{a_p:.6g} (pick {r}); "
                  f"closest alternative {min(gaps):.3g} bounds; nearest edge: jar "
                  f"{float(neg_r.min()):.3g}, friction {float(fr_r.min()):.3g} bounds")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", default="settle",
                    choices=("settle", "locked_like", "table", "table_setting", "chessboard",
                             "mixture", "composer"))
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--capture", choices=("step", "path"), default="path",
                    help="a mesh-family env's capture point (see family_core)")
    ap.add_argument("--earliest", action="store_true",
                    help="list the envs that leave the plain version first")
    ap.add_argument("--trajectory", type=int, default=0, metavar="N",
                    help="for N envs that the tie-following check does not excuse, print "
                         "each iteration's departure and its closest ties")
    ap.add_argument("--envs", default="", help="comma-separated envs for --trajectory "
                                               "(default: the first N not excused)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("cg_near_tie: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from robogym_torch.physics import cg_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {chip_smoke.card_line()}", flush=True)
    seed = chip_smoke.SEED if opts.seed is None else opts.seed
    if opts.world in chip_smoke.FAMILY_CONFIGS:
        ci, its, nfacet = family_core(chip_smoke, opts.world, seed, opts.capture)
    else:
        m, arrays, kw = chip_smoke.worlds()[opts.world]
        d = chip_smoke.start_states(m, arrays, chip_smoke.BATCH, seed, **kw)
        ci, its, nfacet = chip_smoke.capture_core(m, d)
    if opts.trajectory:
        envs = [int(e) for e in opts.envs.split(",") if e]
        return trajectories(chip_smoke, ci, its, nfacet, opts.trajectory, envs)
    x_k, x_p = [], []
    for k in range(its + 1):
        a = chip_smoke.cg_args(ci, k, nfacet)
        x_k.append(cg_kernel.cg_full(*a)[0])
        x_p.append(cg_kernel.cg_full_plain(*a)[0])
    args = chip_smoke.cg_args(ci, its, nfacet)
    tr32 = traced_plain(chip_smoke, args)
    tr64 = traced_plain(chip_smoke, chip_smoke.to_float64(args))
    off = torch.stack([(x_k[k] - x_p[k]).abs().amax(-1) > chip_smoke.CG_EARLY_TOL
                       * x_p[k].abs().max() for k in range(1, its + 1)])          # (its, B)
    final = (x_k[its] - x_p[its]).abs().amax(-1) / x_p[its].abs().max()
    envs = off.any(0).nonzero()[:, 0]
    print(f"[{opts.world} seed {seed}] B={x_k[0].shape[0]}: {len(envs)} envs leave the plain "
          f"version by more than {chip_smoke.CG_EARLY_TOL} of max |qacc| within {its} iterations")
    first = {e: int(off[:, e].nonzero()[0, 0]) + 1 for e in envs.tolist()}
    order = (sorted(first, key=lambda e: (first[e], -float(final[e]))) if opts.earliest
             else sorted(first, key=lambda e: -float(final[e])))
    for env in order[:10]:
        k0 = first[env]
        t32, t64 = tr32[k0 - 1], tr64[k0 - 1]
        p, dc32, pick32 = (t32[key][env] for key in ("p", "dcost", "step"))
        dc64, pick64 = (t64[key][env] for key in ("dcost", "step"))
        bound = chip_smoke.tie_bound(t32["mag"][env].double())
        step = x_k[k0][env] - x_k[k0 - 1][env]
        a_kern = float((step * p).sum() / (p * p).sum().clamp_min(1e-30))
        print(f"  env {env}: qacc off by {float(final[env]):.3g} of max |qacc| after {its}; "
              f"first off after iteration {k0}")
        print(f"    dcost of a1 x (2, 1, 0.5, 0.125), float32: "
              + ", ".join(f"{float(v):.9g}" for v in dc32) + f"; picks a = {float(pick32):.9g}")
        print(f"    tie bounds (chip_smoke.tie_bound): "
              + ", ".join(f"{float(v):.3g}" for v in bound))
        print(f"    dcost, float64: " + ", ".join(f"{float(v):.9g}" for v in dc64)
              + f"; picks a = {float(pick64):.9g}")
        print(f"    the kernel's step there: a = {a_kern:.9g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
