#!/usr/bin/env python3
"""Hold kernel B to chip_smoke.py's checks on several seeded start states of
each world, for one or more builds of the kernel sources.

    python3 tools/cg_seed_sweep.py [--seeds N] [--csrc DIR ...]

Runs on an NVIDIA GPU. For each source directory (the checkout's
`robogym_torch/csrc` by default; another checkout's, for example a parent
commit unpacked with `git archive`, to compare), it builds the kernel
library into a temporary directory, then for each world (goal settle,
locked-like, table setting) and each seed 0..N-1 settles seeded start
states at B=1024 through the port's step (so through that build's kernels),
captures kernel B's inputs from one more substep as chip_smoke.py does, and
runs `chip_smoke.cg_readings`: 1e-4 relative after 1 and 2 iterations, and
after 15 each output's error against a float64 run of the plain version at
most NOISE_RATIO times the float32 plain version's. It prints each state's
verdict with its worst ratio, and the passes per world. A build that does
not export the occupancy entry points of this checkout's cg_full.cu (an
older checkout) needs them appended as stubs to its cg_full.cu.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--csrc", nargs="*", default=[os.path.join(REPO, "robogym_torch", "csrc")])
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("cg_seed_sweep: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from robogym_torch import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {chip_smoke.card_line()}", flush=True)
    world = chip_smoke.worlds()
    with tempfile.TemporaryDirectory() as tmp:
        for i, csrc in enumerate(opts.csrc):
            cuda.CSRC, cuda.BUILD_DIR, cuda._lib = os.path.abspath(csrc), os.path.join(tmp, str(i)), None
            cuda.build()
            for wname in ("settle", "locked_like", "table"):
                m, arrays, kw = world[wname]
                passes = 0
                for seed in range(opts.seeds):
                    d = chip_smoke.start_states(m, arrays, chip_smoke.BATCH, seed, **kw)
                    ci, its, nfacet = chip_smoke.capture_core(m, d)
                    _, early, noise, failures = chip_smoke.cg_readings(
                        "cg_full", lambda k: chip_smoke.cg_args(ci, k, nfacet), its)
                    worst = max(noise[o][0] / max(noise[o][1], 1e-30) for o in noise
                                if o != "qacc_smooth")
                    passes += not failures
                    print(f"[{csrc} {wname} seed {seed}] {'passes' if not failures else 'FAILS'}: "
                          f"worst error ratio to the plain version's {worst:.3g}, largest early "
                          f"error {max(max(e.values()) for e in early.values()):.3g}", flush=True)
                print(f"[{csrc} {wname}] {passes} of {opts.seeds} seeds pass", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
