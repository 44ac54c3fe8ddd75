#!/usr/bin/env python3
"""Plant faults in the fused CG kernel (kernel B) and show whether the check
that `chip_smoke.py` holds the kernel to catches each one.

    python3 tools/cg_fault_check.py

Runs on an NVIDIA GPU. It captures kernel B's inputs from one substep of the
locked-like world at B=1024, as `chip_smoke.py` does. Then, for the sound
source and for each fault below, it copies `robogym_torch/csrc/` into a
temporary directory, plants the fault in the copy's `cg_full.cu` (the
checkout's sources are never changed), builds the copy there, and prints
`chip_smoke.cg_readings` for it and whether the check passes. Exits non-zero
if the sound kernel fails the check or a fault passes it.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# name: (text in cg_full.cu, its faulty replacement)
FAULTS = {
    "sound": None,
    "one_fewer_iteration": ("for (int it = 0; it < p.iterations; ++it)",
                            "for (int it = 0; it < p.iterations - 1; ++it)"),
    "scale_0.125_dropped": ("const float scales[4] = {2.0f, 1.0f, 0.5f, 0.125f};",
                            "const float scales[4] = {2.0f, 1.0f, 0.5f, 0.5f};"),
    "facet_sign": ("return (k % 2 == 0) ? Jn + mu * Jt : Jn - mu * Jt;",
                   "return (k % 2 == 0) ? Jn + mu * Jt : Jn + mu * Jt;"),
}


def build_variant(tmp: str, name: str, fault) -> None:
    """Load the kernel library built from a copy of the checkout's sources
    with `fault` planted."""
    from robogym_torch import cuda

    src = os.path.join(tmp, name)
    shutil.copytree(os.path.join(REPO, "robogym_torch", "csrc"), src)
    if fault is not None:
        path = os.path.join(src, "cg_full.cu")
        with open(path) as f:
            text = f.read()
        if text.count(fault[0]) != 1:
            raise RuntimeError(f"fault {name}: its text is not found once in cg_full.cu")
        with open(path, "w") as f:
            f.write(text.replace(fault[0], fault[1]))
    cuda.CSRC, cuda.BUILD_DIR, cuda._lib = src, os.path.join(tmp, "lib"), None
    cuda.build()


def main() -> int:
    if not torch.cuda.is_available():
        print("cg_fault_check: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from robogym_torch.physics import cg_kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {chip_smoke.card_line()}", flush=True)
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        build_variant(tmp, "capture", None)
        m, arrays = chip_smoke.load_world()
        d = chip_smoke.start_states(m, arrays, chip_smoke.BATCH, chip_smoke.SEED, settle=20)
        ci, iterations, nfacet, _ = chip_smoke.capture_inputs(m, d)
        for name, fault in FAULTS.items():
            build_variant(tmp, name, fault)
            errs, early, noise, failures = chip_smoke.cg_readings(ci, iterations, nfacet)
            print(f"[{name}] " + "; ".join(
                f"after {its}: " + ", ".join(f"{k} {v:.3g}" for k, v in e.items())
                for its, e in early.items()))
            print(f"[{name}] after {iterations}, kernel vs plain (kernel vs float64, plain vs "
                  "float64): " + ", ".join(f"{k} {errs[k]:.3g} ({noise[k][0]:.3g}, "
                                           f"{noise[k][1]:.3g})" for k in errs))
            for its in (1, iterations):
                a = chip_smoke.cg_args(ci, its, nfacet)
                x_k, x_p = cg_kernel.cg_full(*a)[0], cg_kernel.cg_full_plain(*a)[0]
                off = (x_k - x_p).abs().amax(-1) > chip_smoke.CG_EARLY_TOL * x_p.abs().max()
                print(f"[{name}] after {its}: qacc off by more than {chip_smoke.CG_EARLY_TOL} "
                      f"rel in {int(off.sum())} of {x_k.shape[0]} envs; kernel qacc sum "
                      f"{float(x_k.double().sum())!r}")
            print(f"[{name}] check {'FAILS: ' + '; '.join(failures) if failures else 'passes'}",
                  flush=True)
            if bool(failures) != (fault is not None):
                bad.append(name)
    print("cg_fault_check: " + (f"wrong verdict for {bad}" if bad else
                                "the sound kernel passes and every fault fails"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
