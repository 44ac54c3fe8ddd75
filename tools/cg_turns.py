#!/usr/bin/env python3
"""Kernel B (`robogym_torch/csrc/cg_full.cu`) of two builds in turns on the
same operands: outputs compared bit for bit, times taken in turns.

    python3 tools/cg_turns.py --parent DIR [--parent DIR ...]

Runs on an NVIDIA GPU. Captures kernel B's operands at B=1024 as
chip_smoke.py does: one substep of the locked env's reset state on the
dactyl-shaped world (`locked_env`, the timestep shared by the batch), of
the locked-like world (`locked_like`) and of the goal-settle world
(`settle`).

It builds the checkout's `robogym_torch/csrc/` and, for each `--parent`, a
copy of it whose cg_full.cu is DIR's (for example the parent commit's,
taken out with `git show`), each into a temporary directory and named by
DIR's last component. A build whose kernel B takes no timestep stride (its
entry point has one int fewer) is launched through that signature, with
the one timestep it reads. For each `--parent`, each entry's outputs of
that build and of the checkout's (the timestep given once, stride 0) are
compared (`torch.equal`, and the envs that differ), and the two are timed
in turns: DIR, checkout, checkout, DIR (`chip_smoke.timed_ms`). Exits
non-zero if any output differs.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import hull_turns  # noqa: E402  (tools/, beside this script)

CHECKOUT_INTS = 7   # kernel B's ints with the timestep stride


def capture(chip_smoke):
    """{entry: (core inputs, iterations, facets)} at B=1024."""
    from robogym_torch.envs.dactyl import locked

    world = chip_smoke.worlds()
    out = {}
    env = locked.make_env(device="cuda", seed=chip_smoke.SEED)
    state, _ = env.reset(chip_smoke.BATCH)
    out["locked_env"] = chip_smoke.capture_core(env.model, state.physics)
    for name in ("locked_like", "settle"):
        m, arrays, kw = world[name]
        d = chip_smoke.start_states(m, arrays, chip_smoke.BATCH, chip_smoke.SEED, **kw)
        out[name] = chip_smoke.capture_core(m, d)
    return out


def use(builds, name):
    """Make build `name` the one that `cg_kernel.cg_full` launches: its
    library, and for a build without the timestep stride its signature
    (the launch drops the stride)."""
    from robogym_torch import cuda

    lib, n_int = builds[name]
    cuda._lib = lib
    cuda.SIGNATURES["cg_full"] = (28, n_int)
    cuda.launch = LAUNCH if n_int == CHECKOUT_INTS else _strideless


def _strideless(name, *args):
    return LAUNCH(name, *(args[:-1] if name == "cg_full" else args))


LAUNCH = None


def main() -> int:
    global LAUNCH
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR", action="append", required=True,
                    help="a directory holding another cg_full.cu (may be given again)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("cg_turns: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from robogym_torch import cuda
    from robogym_torch.physics import cg_kernel

    LAUNCH = cuda.launch
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {chip_smoke.card_line()}", flush=True)
    others = {os.path.basename(os.path.normpath(d)): os.path.join(d, "cg_full.cu")
              for d in opts.parent}
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for name, src in [*others.items(), ("checkout", None)]:
            with open(src or os.path.join(hull_turns.CSRC, "cg_full.cu")) as f:
                n_int = CHECKOUT_INTS if "int dt_stride" in f.read() else CHECKOUT_INTS - 1
            cuda.SIGNATURES["cg_full"] = (28, n_int)
            lib, so, log = hull_turns.build(tmp, name, src, "cg_full.cu")
            builds[name] = (lib, n_int)
            regs = hull_turns.registers(log, "cg_full")
            print(f"[{name}] built {so}; kernel B takes {'a' if n_int == CHECKOUT_INTS else 'no'} "
                  f"timestep stride; " + "; ".join(f"{fn}: {r} registers, spills {st}/{ld} B"
                                                   for fn, (r, st, ld) in regs.items()))
        use(builds, "checkout")
        ops = capture(chip_smoke)
        for other in others:
            for entry, (ci, its, nfacet) in ops.items():
                args = chip_smoke.cg_args(ci, its, nfacet)
                got = {}
                for name in (other, "checkout"):
                    use(builds, name)
                    got[name] = cg_kernel.cg_full(*args)
                torch.cuda.synchronize()
                equal = all(torch.equal(a, b) for a, b in zip(got[other], got["checkout"]))
                off = sum(int((a != b).flatten(1).any(1).sum())
                          for a, b in zip(got[other], got["checkout"]))
                t = []
                for name in (other, "checkout", "checkout", other):
                    use(builds, name)
                    t.append(chip_smoke.timed_ms(lambda: cg_kernel.cg_full(*args), chip_smoke.REPS))
                print(f"[turns {other}] {entry}: B={ci['qM'].shape[0]} V={ci['qM'].shape[-1]} "
                      f"E={len(ci['kind'])}, outputs equal to the checkout's (stride 0): {equal} "
                      f"({off} env outputs differ); {other} / checkout / checkout / {other}: "
                      + " / ".join(f"{v:.4f}" for v in t)
                      + f" ms; {other} / checkout {(t[0] + t[3]) / (t[1] + t[2]):.3f}", flush=True)
                if not equal:
                    bad.append(f"{other}/{entry}")
        use(builds, "checkout")
    print("cg_turns: " + (f"outputs differ: {bad}" if bad else "every output is bit-equal"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
