#!/usr/bin/env python3
"""Kernel A (`robogym_torch/csrc/spd_inverse.cu`) at every size it takes.

    python3 tools/spd_sizes.py

Runs on an NVIDIA GPU. Prints what `nvcc -Xptxas -v` reports for each
instance of kernel A (registers, spills), then holds the kernel at every V
from 1 to 256 (the register instances up to 64, the block kernel with the
matrix in shared memory up to 240, in device memory above) to
`chip_smoke.spd_readings` (1e-5 of the plain version's largest entry; per
column against a float64 inverse at most `SPD_COLUMN_RATIO` times the
plain version's; bit-symmetric) on seeded SPD matrices X X^T / V + I at
B=64, and prints the readings and the layout (`cuda.spd_inverse_info`) at
the sizes that start or end an instance. Exits non-zero if a reading
fails.
"""

from __future__ import annotations

import os
import re
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHOWN = (1, 8, 9, 30, 32, 33, 36, 40, 41, 48, 56, 64, 65, 96, 128, 129, 160, 161, 200, 240,
         241, 256)
MAX_V = 256


def main() -> int:
    if not torch.cuda.is_available():
        print("spd_sizes: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from robogym_torch import cuda
    print(f"[device] {chip_smoke.card_line()}", flush=True)
    name = None
    for line in cuda.build().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1) if "spd_inverse" in m.group(1) else None
        elif name and ("registers" in line or "spill" in line):
            print(f"[ptxas] {name}: {line.strip()}")
    bad = []
    for V in range(1, MAX_V + 1):
        rng = np.random.default_rng(V)
        X = rng.standard_normal((64, V, V))
        A = torch.as_tensor((X @ X.transpose(0, 2, 1) / V + np.eye(V)).astype(np.float32),
                            device="cuda")
        r, failures = chip_smoke.spd_readings(A)
        bad += [f"V={V}: {f}" for f in failures]
        if V in SHOWN or failures:
            print(f"[V={V}] rel err {r['max_err']:.3g} (tol {chip_smoke.SPD_TOL}); per-column err "
                  f"{r['column']:.3g}, plain version's {r['plain_column']:.3g}; bit-symmetric "
                  f"{r['symmetric']}; layout {cuda.spd_inverse_info(V)}")
    print("spd_sizes: " + (f"readings fail: {bad}" if bad else
                           f"every V from 1 to {MAX_V} passes"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
