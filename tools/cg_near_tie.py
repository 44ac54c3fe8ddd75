#!/usr/bin/env python3
"""Find the envs where kernel B leaves its plain version, and show the line
search there.

    python3 tools/cg_near_tie.py [--world settle|locked_like|table] [--seed N]

Runs on an NVIDIA GPU. It captures kernel B's inputs from one substep of a
world at B=1024 as `chip_smoke.py` does (start states from `--seed`, by
default chip_smoke.py's), runs the kernel and the plain version for 1 to
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
the discrete line search, not a fault of the kernel.
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
    recorded: [(search direction, costs (B, 4), step)]."""
    from robogym_torch.physics import cg_kernel

    trace = []
    cg_kernel.cg_full_plain(*args, solve=functools.partial(cg_kernel.cg_plain, trace=trace))
    return trace


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", default="settle", choices=("settle", "locked_like", "table"))
    ap.add_argument("--seed", type=int, default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("cg_near_tie: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from robogym_torch.physics import cg_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {chip_smoke.card_line()}", flush=True)
    m, arrays, kw = chip_smoke.worlds()[opts.world]
    seed = chip_smoke.SEED if opts.seed is None else opts.seed
    d = chip_smoke.start_states(m, arrays, chip_smoke.BATCH, seed, **kw)
    ci, its, nfacet = chip_smoke.capture_core(m, d)
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
    for env in sorted(envs.tolist(), key=lambda e: -float(final[e]))[:10]:
        k0 = int(off[:, env].nonzero()[0, 0]) + 1
        p, dc32, pick32 = (t[env] for t in tr32[k0 - 1])
        _, dc64, pick64 = (t[env] for t in tr64[k0 - 1])
        step = x_k[k0][env] - x_k[k0 - 1][env]
        a_kern = float((step * p).sum() / (p * p).sum().clamp_min(1e-30))
        print(f"  env {env}: qacc off by {float(final[env]):.3g} of max |qacc| after {its}; "
              f"first off after iteration {k0}")
        print(f"    dcost of a1 x (2, 1, 0.5, 0.125), float32: "
              + ", ".join(f"{float(v):.9g}" for v in dc32) + f"; picks a = {float(pick32):.9g}")
        print(f"    dcost, float64: " + ", ".join(f"{float(v):.9g}" for v in dc64)
              + f"; picks a = {float(pick64):.9g}")
        print(f"    the kernel's step there: a = {a_kern:.9g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
