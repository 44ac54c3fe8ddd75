#!/usr/bin/env python3
"""Time the hull kernels of two builds of `robogym_torch/csrc/hull_sweep.cu`
in turns on the same operands, compare their outputs bit for bit, and read
what the compiler made of each build.

    python3 tools/hull_turns.py [--parent DIR ...] [--out DIR]

Runs on an NVIDIA GPU. Captures operands at B=1024 as chip_smoke.py does:
the hull winners of one locked-like substep (C `hull_manifold`, K=24, V1=8,
V2=64, DX=6; D `hull_pair`, K=8, V=64), the table world's two
`hull_manifold` calls (C@table-box: K=5, V1=8, V2=64, DX=6; C@table: K=10,
V1=V2=64, DX=0), and the same pairs placed in the world by
`world_from_loc` (H, H@table-box, H@table, G).

It builds the checkout's `robogym_torch/csrc/` and, for each `--parent`, a
copy of it whose hull_sweep.cu is DIR's (for example the parent commit's,
taken out with `git show`), each into a temporary directory and named by
DIR's last component. For each build it
prints the hull kernels' registers, spills and warps an SM as the register
file allows them (from `nvcc -Xptxas -v`), the layouts that the build
reports where it exports `robogym_hull_info`, and the SASS of each hull
kernel (`cuobjdump -sass`): its instructions, shuffles, shared and global
loads, and each loop's instructions and shuffles (the hull kernels'
listings go to OUT/hull_sass_<build>.txt). Then C's, C@table's, D's and
G's times at BK/2, BK and 2 BK pairs (the operands sliced to B=512 and
repeated to B=2048): time in proportion to BK is a throughput-bound
kernel, flat time a latency-bound one or a tail of too few warps.

For each `--parent`, each kernel's outputs of that build and of the
checkout's are compared (`torch.equal`, and the pair slots that differ),
and the two are timed in turns: DIR, checkout, checkout, DIR
(`chip_smoke.timed_ms`).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import shutil
import subprocess
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(REPO, "robogym_torch", "csrc")
REG_FILE = 65536            # 32-bit registers an SM
REG_UNIT = 256              # registers are allocated a warp at a time, in units of 256
MAX_WARPS, MAX_BLOCKS = 64, 32


def warps_by_registers(regs: int, threads: int) -> int:
    """Warps an SM that a kernel of `regs` registers a thread and blocks of
    `threads` threads can hold by the register file alone (each of the
    four schedulers holds a quarter of it)."""
    per_warp = -(-regs * 32 // REG_UNIT) * REG_UNIT
    warps = 4 * (REG_FILE // 4 // per_warp)
    blocks = min(warps // (threads // 32), MAX_BLOCKS)
    return min(blocks * threads // 32, MAX_WARPS)


def build(tmp: str, name: str, other: str | None, file: str = "hull_sweep.cu"):
    """Load the kernel library built from a copy of the checkout's sources,
    with `other` as its `file` where given. Returns (library, path of the
    .so, compiler report)."""
    from robogym_torch import cuda

    src = os.path.join(tmp, name)
    shutil.copytree(CSRC, src)
    if other:
        shutil.copy(other, os.path.join(src, file))
    cuda.CSRC, cuda.BUILD_DIR, cuda._lib = src, os.path.join(tmp, "lib_" + name), None
    cuda._size.cache_clear()
    log = cuda.build()
    return cuda._lib, glob.glob(os.path.join(cuda.BUILD_DIR, "*.so"))[0], log


def demangle(names):
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None:
        return list(names)
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    got = out.stdout.splitlines()
    return got if len(got) == len(names) else list(names)


def registers(log: str, key: str = "hull"):
    """{demangled kernel whose name holds `key`: (registers, spill stores,
    spill loads)} from the `-Xptxas -v` report."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1) if key in m.group(1) else None
        elif cur and "spill" in line:
            s = [int(x) for x in re.findall(r"(\d+) bytes spill", line)]
            out.setdefault(cur, [0, 0, 0])[1:] = s[:2]
        elif cur and "Used" in line:
            out.setdefault(cur, [0, 0, 0])[0] = int(re.search(r"Used (\d+) registers", line)[1])
    return dict(zip(demangle(list(out)), out.values()))


def opcode(ins: str) -> str:
    return re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]


def sass(lib_path: str, dump: str, key: str = "hull"):
    """Per kernel of the library whose name holds `key`: instructions,
    opcode classes, loops (a backward branch and its body) and its
    instructions as text ("listing"), from `cuobjdump -sass`; their
    listing is written to `dump`."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur, kept = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), []) if key in m.group(1) else None
        if cur is None:
            continue
        kept.append(line)
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m:
            cur.append((int(m.group(1), 16), m.group(2)))
    os.makedirs(os.path.dirname(os.path.abspath(dump)), exist_ok=True)
    with open(dump, "w") as f:
        f.write("\n".join(kept) + "\n")
    out = {}
    for name, ins in zip(demangle(list(funcs)), funcs.values()):
        ops = [opcode(i).split(".")[0] for _, i in ins]
        loops = []
        for addr, i in ins:
            t = re.search(r"0x[0-9a-f]+", i) if opcode(i).startswith("BRA") else None
            if t and int(t.group(0), 16) < addr:
                body = [opcode(x).split(".")[0] for a, x in ins if int(t.group(0), 16) <= a <= addr]
                loops.append((int(t.group(0), 16), addr, len(body), body.count("SHFL"),
                              body.count("LDS"), sum(o in ("FMUL", "FADD", "FFMA", "FMNMX")
                                                     for o in body)))
        out[name] = dict(instructions=len(ins), shfl=ops.count("SHFL"), lds=ops.count("LDS"),
                         sts=ops.count("STS"), ldg=ops.count("LDG"), stg=ops.count("STG"),
                         bar=ops.count("BAR"), fp=sum(o in ("FMUL", "FADD", "FFMA", "FMNMX")
                                                      for o in ops),
                         cvt=sum(o.startswith("F2F") for o in ops), loops=loops,
                         listing=[i for _, i in ins])
    return out


def capture(chip_smoke):
    """{entry: (kernel name, operands, DX)} at B=1024."""
    from robogym_torch.physics import step
    from robogym_torch.physics.collision import convex_kernel as ck

    world = chip_smoke.worlds()
    out = {}
    m, arrays, kw = world["locked_like"]
    d = chip_smoke.start_states(m, arrays, chip_smoke.BATCH, chip_smoke.SEED, **kw)
    for name, letter in (("hull_manifold", "C"), ("hull_pair", "D")):
        *args, DX = chip_smoke.capture_call(ck, name, lambda: step.fwd_position(m, d))
        out[letter] = (name, tuple(args), DX)
        out[chip_smoke.HULL_LETTER[name + "_world"]] = (name + "_world", chip_smoke.to_world(args),
                                                        DX)
    m, arrays, kw = world["table"]
    d = chip_smoke.start_states(m, arrays, chip_smoke.BATCH, chip_smoke.SEED, **kw)
    box, mesh = chip_smoke.capture_calls(ck, "hull_manifold", lambda: step.fwd_position(m, d))
    for at, (*args, DX) in (("table-box", box), ("table", mesh)):
        out["C@" + at] = ("hull_manifold", tuple(args), DX)
        out["H@" + at] = ("hull_manifold_world", chip_smoke.to_world(args), DX)
    return out


def run(name, args, DX):
    from robogym_torch.physics.collision import convex_kernel as ck

    return getattr(ck, name)(*args, DX)


def report_build(name, so, log, out):
    """Print a build's registers and SASS of the hull kernels."""
    print(f"[{name}] built {so}")
    for fn, (regs, st, ld) in registers(log).items():
        print(f"  {fn}: {regs} registers, spill stores {st} B, loads {ld} B; "
              f"{warps_by_registers(regs, 128)} warps an SM by the register file at 128 "
              "threads a block")
    for fn, s in sass(so, os.path.join(out, f"hull_sass_{name}.txt")).items():
        print(f"  SASS {fn}: {s['instructions']} instructions, SHFL {s['shfl']}, LDS {s['lds']}, "
              f"LDG {s['ldg']}, FMUL/FADD/FFMA/FMNMX {s['fp']}, F2F* {s['cvt']}")
        for start, end, n, shfl, lds, fp in s["loops"]:
            print(f"    loop {start:#06x}-{end:#06x}: {n} instructions, SHFL {shfl}, LDS {lds}, "
                  f"FMUL/FADD/FFMA/FMNMX {fp}")


def report_layout(chip_smoke, name, ops):
    """Print the hull kernels' layouts that the loaded build reports, if
    it exports them."""
    from robogym_torch import cuda

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for entry in ("C", "H", "D", "G", "C@table", "C@table-box"):
        kernel, args, DX = ops[entry]
        world = kernel.endswith("_world")
        try:
            lay = cuda.hull_info(kernel, args[0].shape[-1], args[1 if world else 3].shape[-1], DX)
        except AttributeError:
            return
        bk = args[0].shape[0] * args[0].shape[1]
        print(f"[{name}] {entry}: {lay['smem_bytes']} B of shared memory a block, "
              f"{lay['registers']} registers, {lay['blocks_per_sm'] * lay['threads'] // 32} warps "
              f"an SM, {lay['pairs_per_block']} pairs a block, "
              f"{bk / (lay['pairs_per_block'] * lay['blocks_per_sm'] * sms):.2f} waves")


def report_scaling(chip_smoke, name, ops):
    """Print C's, C@table's, D's and G's times at BK/2, BK and 2 BK
    pairs."""
    for entry in ("C", "C@table", "D", "G"):
        kernel, args, DX = ops[entry]
        half = tuple(a[: a.shape[0] // 2].contiguous() for a in args)
        double = tuple(torch.cat([a, a]).contiguous() for a in args)
        t = [chip_smoke.timed_ms(lambda x=x: run(kernel, x, DX), chip_smoke.REPS)
             for x in (half, args, double)]
        bk = args[0].shape[0] * args[0].shape[1]
        print(f"[{name}] {entry} at BK = {bk // 2} / {bk} / {2 * bk}: "
              + " / ".join(f"{x:.4f}" for x in t)
              + f" ms; ratios to BK/2: 1 / {t[1] / t[0]:.2f} / {t[2] / t[0]:.2f}")


def report_turns(chip_smoke, other, builds, ops):
    """Each kernel of build `other` against the checkout's: outputs bit for
    bit, then times in turns (other, checkout, checkout, other)."""
    from robogym_torch import cuda

    for entry, (kernel, args, DX) in ops.items():
        got = {}
        for name in (other, "checkout"):
            cuda._lib = builds[name]
            got[name] = run(kernel, args, DX)
        torch.cuda.synchronize()
        pairs = list(zip(got[other], got["checkout"]))
        equal = all(torch.equal(a, b) for a, b in pairs)
        off = sum(int((a != b).reshape(a.shape[0], a.shape[1], -1).any(-1).sum()) for a, b in pairs)
        diff = max(float((a - b).abs().max()) for a, b in pairs)
        t = []
        for name in (other, "checkout", "checkout", other):
            cuda._lib = builds[name]
            t.append(chip_smoke.timed_ms(lambda: run(kernel, args, DX), chip_smoke.REPS))
        print(f"[turns {other}] {entry} {kernel}: outputs equal to the checkout's: {equal} "
              f"({off} pair slots differ, max abs diff {diff:.3g}); {other} / checkout / "
              f"checkout / {other}: " + " / ".join(f"{x:.4f}" for x in t)
              + f" ms; {other} / checkout {(t[0] + t[3]) / (t[1] + t[2]):.2f}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR", action="append", default=[],
                    help="a directory holding another hull_sweep.cu (may be given again)")
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out"),
                    help="where the SASS listings go")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("hull_turns: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from robogym_torch import cuda

    print(f"[device] {chip_smoke.card_line()}", flush=True)
    others = {os.path.basename(os.path.normpath(d)): os.path.join(d, "hull_sweep.cu")
              for d in opts.parent}
    with tempfile.TemporaryDirectory() as tmp:
        builds = {}
        for name, hull in [*others.items(), ("checkout", None)]:
            builds[name], so, log = build(tmp, name, hull)
            report_build(name, so, log, opts.out)
        cuda._lib = builds["checkout"]
        ops = capture(chip_smoke)
        for entry, (kernel, args, DX) in ops.items():
            B, K, _, V1 = args[0].shape
            V2 = args[1 if kernel.endswith("_world") else 3].shape[-1]
            print(f"[operands] {entry} {kernel}: B={B} K={K} BK={B * K} V1={V1} V2={V2} DX={DX}")
        for name, lib in builds.items():
            cuda._lib = lib
            report_layout(chip_smoke, name, ops)
            report_scaling(chip_smoke, name, ops)
        for other in others:
            report_turns(chip_smoke, other, builds, ops)
    return 0


if __name__ == "__main__":
    sys.exit(main())
