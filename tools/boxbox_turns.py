#!/usr/bin/env python3
"""Time the box-box kernel (E, `robogym_torch/csrc/boxbox.cu`) of two builds
in turns on the same operands, compare their outputs bit for bit, and read
what the compiler made of each build.

    python3 tools/boxbox_turns.py [--parent DIR ...] [--variants] [--out DIR]

Runs on an NVIDIA GPU. Captures E's operands at B=1024 as chip_smoke.py
does (`E`: the box-box call of one goal-settle substep, K=15), and takes
the three cases of tests/test_torch_kernels.py (`_box_cases`: random,
stack, tie; B=4, K=6).

It builds the checkout's `robogym_torch/csrc/` and, for each `--parent`, a
copy of it whose boxbox.cu is DIR's (for example the parent commit's, taken
out with `git show`), each into a temporary directory and named by DIR's
last component. `--variants` adds copies of the checkout's boxbox.cu with
its other layouts as if each were a `--parent`, named by what they set:
`g8` or `g16` (lanes a pair, the one the checkout does not have) and
`w2`, `w4`, `w8` (warps a block, the two it does not have). For each
build it prints E's registers and spills (`nvcc -Xptxas -v`), the layout
that the build reports where it exports
`robogym_boxbox_info` (lanes a pair, pairs a block, shared memory, warps an
SM, waves), and the SASS of the kernel (`cuobjdump -sass`: instructions,
shuffles, shared and global loads and stores, float operations; listings
in OUT/boxbox_sass_<build>.txt); then E's times at BK/2, BK and 2 BK pairs
(the operands sliced to B=512 and repeated to B=2048): time in proportion
to BK is a throughput-bound kernel, flat time a latency-bound one.

For each `--parent` and variant, its outputs and the checkout's are
compared (`torch.equal`, and the pairs that differ) on E's operands and on
each case, and the two are timed in turns at BK/2, BK and 2 BK: DIR,
checkout, checkout, DIR (`chip_smoke.timed_ms`).
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import hull_turns  # noqa: E402  (tools/, beside this script)

KEY = "boxbox"
# the layout constants of the checkout's source and the values the
# variants give them, each variant named by its letter and value
LAYOUT = {"kGroup": ("g", (8, 16)), "kWarps": ("w", (2, 4, 8))}


def variants(tmp):
    """{name: path} of the `--variants` copies of the checkout's source:
    each other value of each layout constant."""
    with open(os.path.join(hull_turns.CSRC, "boxbox.cu")) as f:
        src = f.read()
    out = {}
    for const, (letter, values) in LAYOUT.items():
        pat = rf"constexpr int {const} = (\d+);"
        found = re.findall(pat, src)
        if len(found) != 1:
            raise RuntimeError(f"variant {const}: it is not defined once")
        for new in (v for v in values if v != int(found[0])):
            name = f"{letter}{new}"
            os.makedirs(os.path.join(tmp, "src_" + name))
            out[name] = os.path.join(tmp, "src_" + name, "boxbox.cu")
            with open(out[name], "w") as f:
                f.write(re.sub(pat, f"constexpr int {const} = {new};", src))
    return out


def capture(chip_smoke):
    """{entry: operands}: E at B=1024 and the three cases."""
    from robogym_torch.physics import step
    from robogym_torch.physics.collision import boxbox_kernel

    sys.path.insert(0, os.path.join(REPO, "tests"))
    from test_torch_kernels import _box_cases

    m, arrays, kw = chip_smoke.worlds()["settle"]
    d = chip_smoke.start_states(m, arrays, chip_smoke.BATCH, chip_smoke.SEED, **kw)
    ops = {"E": chip_smoke.capture_call(boxbox_kernel, "boxbox", lambda: step.fwd_position(m, d))}
    for name, case in _box_cases().items():
        ops[name] = tuple(torch.as_tensor(a, device=m.device) for a in case)
    return ops


def sizes(args):
    """E's operands at BK/2, BK and 2 BK pairs."""
    return {"BK/2": tuple(a[: a.shape[0] // 2].contiguous() for a in args), "BK": args,
            "2BK": tuple(torch.cat([a, a]).contiguous() for a in args)}


def run(args):
    from robogym_torch.physics.collision import boxbox_kernel

    return boxbox_kernel.boxbox(*args)


def report_build(name, so, log, out):
    print(f"[{name}] built {so}")
    for fn, (regs, st, ld) in hull_turns.registers(log, KEY).items():
        print(f"  {fn}: {regs} registers, spill stores {st} B, loads {ld} B")
    for fn, s in hull_turns.sass(so, os.path.join(out, f"boxbox_sass_{name}.txt"), KEY).items():
        print(f"  SASS {fn}: {s['instructions']} instructions, SHFL {s['shfl']}, LDS {s['lds']}, "
              f"STS {s['sts']}, LDG {s['ldg']}, STG {s['stg']}, BAR {s['bar']}, "
              f"FMUL/FADD/FFMA/FMNMX {s['fp']}, loops {len(s['loops'])}")
        for start, end, n, shfl, lds, fp in s["loops"]:
            print(f"    loop {start:#06x}-{end:#06x}: {n} instructions, SHFL {shfl}, LDS {lds}, "
                  f"FMUL/FADD/FFMA/FMNMX {fp}")


def report_layout(chip_smoke, name, ops):
    """The layout the loaded build reports, if it exports it."""
    from robogym_torch import cuda

    if not hasattr(cuda._lib, "robogym_boxbox_info"):
        return
    chip_smoke.boxbox_layout(ops["E"][0].shape[0] * ops["E"][0].shape[1], f"{name}] [E boxbox")


def report_scaling(chip_smoke, name, ops):
    t = {k: chip_smoke.timed_ms(lambda x=x: run(x), chip_smoke.REPS)
         for k, x in sizes(ops["E"]).items()}
    print(f"[{name}] E at BK/2, BK, 2 BK: " + " / ".join(f"{x:.4f}" for x in t.values())
          + f" ms; ratios to BK/2: 1 / {t['BK'] / t['BK/2']:.2f} / {t['2BK'] / t['BK/2']:.2f}")


def report_turns(chip_smoke, other, builds, ops):
    """Build `other` against the checkout's: outputs bit for bit on every
    entry, then E's times in turns (other, checkout, checkout, other)."""
    from robogym_torch import cuda

    for entry, args in ops.items():
        got = {}
        for name in (other, "checkout"):
            cuda._lib = builds[name]
            got[name] = run(args)
        torch.cuda.synchronize()
        pairs = list(zip(got[other], got["checkout"]))
        equal = all(torch.equal(a, b) for a, b in pairs)
        off = (sum((a != b).reshape(a.shape[0], a.shape[1], -1).any(-1) for a, b in pairs) > 0)
        where = [tuple(int(i) for i in ix) for ix in off.nonzero()[:8]]
        print(f"[turns {other}] {entry}: outputs equal to the checkout's: {equal} "
              f"({int(off.sum())} of {off.numel()} pairs differ" + (f", first {where}" if where
                                                                    else "") + ")")
    for size, x in sizes(ops["E"]).items():
        t = []
        for name in (other, "checkout", "checkout", other):
            cuda._lib = builds[name]
            t.append(chip_smoke.timed_ms(lambda: run(x), chip_smoke.REPS))
        print(f"[turns {other}] E at {size} (B={x[0].shape[0]}): {other} / checkout / checkout / "
              f"{other}: " + " / ".join(f"{v:.4f}" for v in t)
              + f" ms; {other} / checkout {(t[0] + t[3]) / (t[1] + t[2]):.2f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR", action="append", default=[],
                    help="a directory holding another boxbox.cu (may be given again)")
    ap.add_argument("--variants", action="store_true",
                    help="also the checkout's source with its other layouts")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"),
                    help="where the SASS listings go")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("boxbox_turns: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from robogym_torch import cuda

    print(f"[device] {chip_smoke.card_line()}", flush=True)
    others = {os.path.basename(os.path.normpath(d)): os.path.join(d, "boxbox.cu")
              for d in opts.parent}
    with tempfile.TemporaryDirectory() as tmp:
        if opts.variants:
            others.update(variants(tmp))
        builds = {}
        for name, src in [*others.items(), ("checkout", None)]:
            builds[name], so, log = hull_turns.build(tmp, name, src, "boxbox.cu")
            report_build(name, so, log, opts.out)
        cuda._lib = builds["checkout"]
        ops = capture(chip_smoke)
        for entry, args in ops.items():
            print(f"[operands] {entry}: B={args[0].shape[0]} K={args[0].shape[1]}")
        for name, lib in builds.items():
            cuda._lib = lib
            report_layout(chip_smoke, name, ops)
            report_scaling(chip_smoke, name, ops)
        for other in others:
            report_turns(chip_smoke, other, builds, ops)
    return 0


if __name__ == "__main__":
    sys.exit(main())
