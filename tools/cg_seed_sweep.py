#!/usr/bin/env python3
"""Hold the CG kernels to chip_smoke.py's checks on several seeded start
states of each world, for one or more builds of the kernel sources, and
compare the builds' outputs bit for bit.

    python3 tools/cg_seed_sweep.py [--seeds N] [--csrc DIR ...] [--device-j]

Runs on an NVIDIA GPU. For each source directory (the checkout's
`robogym_torch/csrc` by default; another checkout's, for example a parent
commit unpacked with `git archive`, to compare), it builds the kernel
library into a temporary directory, then for each world and each seed
0..N-1 settles seeded start states at B=1024 through the port's step (so
through that build's kernels), captures a CG kernel's inputs from one more
substep or call as chip_smoke.py does, and runs `chip_smoke.cg_readings`:
the plain version forced through the float32 ties where the kernel parts
from it (no env may leave it otherwise), 1e-4 relative after 1 and 2
iterations, and after 15 each output's error against a float64 run at most
2 times the plain version's. Kernel B (`cg_full`) on the goal-settle,
locked-like and table worlds and on the chessboard's and the mixture's
states (the env built once, its generator seeded, reset, and B's inputs
from one env step), B without the Euler update (`cg_full_noeuler`, one
`forward()`) on the locked-like world, and F (`cg`) on the hand world.
Each state prints the envs excused on ties and the first witnesses.
It prints each build's CG kernel instances with their registers and
spills, each state's verdict with its worst ratio of the kernel's error
against float64 to the plain version's, and the passes per world.

Then, on the seed-0 inputs that the first build's states gave, it runs
every other build's kernels, says whether their outputs after 15
iterations equal the first build's bit for bit, and times each kernel for
the first build and the other in turns (first, other, other, first;
`chip_smoke.timed_ms`). `--device-j` adds to these comparisons, and to
no sweep, a build of the first source directory whose kernel F always
keeps J in device memory (its size route), so that F's two routes are
compared on the hand world's inputs.

A source directory of an older checkout gets stubs of the entry points
that this checkout's `robogym_torch/cuda.py` binds and it lacks, appended
to a copy of its cg_full.cu; where its cg.cu takes no scratch buffer (12
pointers), F is launched through that older signature.
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# entry points cuda.py binds: name -> a stub for a build that lacks it
STUBS = {
    "robogym_max_smem_bytes": 'extern "C" long long robogym_max_smem_bytes() { return 232448; }',
    "robogym_cg_smem_bytes": 'extern "C" long long robogym_cg_smem_bytes(int, int) { return 0; }',
    "robogym_cg_scratch_floats":
        'extern "C" long long robogym_cg_scratch_floats(int, int) { return 0; }',
    "robogym_cg_full_smem_bytes":
        'extern "C" long long robogym_cg_full_smem_bytes(int, int, int) { return 0; }',
    "robogym_cg_blocks_per_sm": 'extern "C" int robogym_cg_blocks_per_sm(int, int) { return 1; }',
    "robogym_cg_full_blocks_per_sm":
        'extern "C" int robogym_cg_full_blocks_per_sm(int, int, int) { return 1; }',
}
WORLDS = (("settle", "cg_full"), ("locked_like", "cg_full"), ("locked_like", "cg_full_noeuler"),
          ("table", "cg_full"), ("hand", "cg"), ("chessboard", "cg_full"), ("mixture", "cg_full"))
# the mesh-family envs among WORLDS: their states come from an env's reset
FAMILY_ENVS = ("chessboard", "mixture")


def prepare(csrc: str, dst: str) -> bool:
    """Copy `csrc` to `dst` with stubs of the entry points it lacks; returns
    whether its F takes a scratch buffer (this checkout's signature)."""
    shutil.copytree(csrc, dst)
    text = "".join(open(os.path.join(dst, f)).read() for f in os.listdir(dst))
    missing = [stub for name, stub in STUBS.items() if name + "(" not in text]
    if missing:
        with open(os.path.join(dst, "cg_full.cu"), "a") as f:
            f.write("\n" + "\n".join(missing) + "\n")
    return "robogym_cg_scratch_floats(" in open(os.path.join(dst, "cg.cu")).read()


def load(src: str, build_dir: str, scratch: bool) -> str:
    """Load the library built from `src`, with F's signature of its build;
    returns its compiler report."""
    from robogym_torch import cuda
    from robogym_torch.physics import cg_kernel

    cuda.CSRC, cuda.BUILD_DIR, cuda._lib = src, build_dir, None
    cuda._size.cache_clear()
    cuda.SIGNATURES["cg"] = (13, 4) if scratch else (12, 4)
    cg_kernel.cg = CG if scratch else legacy_cg
    return cuda.build()


def registers(log: str) -> str:
    """The CG kernel instances of an `nvcc -Xptxas -v` report with their
    registers and spill stores."""
    out, name, spill = [], None, "0"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '[^']*?(cg_full_kernel|cg_kernel)I(\w*?)EEvNS", line)
        if m:
            name = m.group(1) + "<" + ",".join(re.findall(r"L[ib](\d+)", m.group(2))) + ">"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.append(f"{name} {m.group(1)} regs, {spill} B spilled")
            name = None
    return "; ".join(out)


def legacy_cg(J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, iterations: int):
    """Kernel F through the signature of a build without scratch."""
    from robogym_torch import cuda

    B, E, V = J.shape
    x = torch.empty((B, V), dtype=torch.float32, device=M.device)
    f = torch.empty((B, E), dtype=torch.float32, device=M.device)
    cuda.launch("cg", J, aref, Deq, Done, Dfr, floss, M, Minv, qs, x0, x, f, B, E, V, iterations)
    return x, f


CG = None


def force_device_route(src: str) -> None:
    """Make kernel F in the sources at `src` keep J in device memory at
    every size."""
    path = os.path.join(src, "cg.cu")
    text = open(path).read()
    route = "bool device_route(int E, int V) {"
    if text.count(route) != 1:
        raise RuntimeError(f"{path}: F's route is not found once")
    open(path, "w").write(text.replace(route, route + " return true;"))


FAMILY = {}


def family_env(chip_smoke, name):
    """The mesh-family env `name` at B=1024 as chip_smoke.py builds it,
    built once."""
    import importlib

    if name not in FAMILY:
        make_env = importlib.import_module("robogym_torch.envs.rearrange." + name).make_env
        FAMILY[name] = make_env(*chip_smoke.FAMILY_CONFIGS[name], device="cuda")
    return FAMILY[name]


def capture(chip_smoke, world, wname, kernel, seed):
    """(args_of, iterations) of `kernel` from a seeded state of `wname`: a
    world's start states settled through the step, or a mesh-family env's
    reset (its generator seeded with `seed`) and one env step from it,
    where chip_smoke.py takes B's inputs."""
    from robogym_torch.physics import cg_kernel, constraint_batched, step

    if wname in FAMILY_ENVS:
        env = family_env(chip_smoke, wname)
        env.generator.manual_seed(seed)
        state, _ = env.reset(chip_smoke.BATCH)
        ci, its, nfacet = chip_smoke.capture_rearrange(env, state, ())["main"]
        return (lambda k: chip_smoke.cg_args(ci, k, nfacet)), its
    m, arrays, kw = world[wname]
    d = chip_smoke.start_states(m, arrays, chip_smoke.BATCH, seed, **kw)
    if kernel == "cg_full":
        ci, its, nfacet = chip_smoke.capture_core(m, d)
        return (lambda k: chip_smoke.cg_args(ci, k, nfacet)), its
    if kernel == "cg":
        fa = chip_smoke.capture_call(cg_kernel, "cg", lambda: step.step(m, d))
        return (lambda k: (*fa[:-1], k)), fa[-1]
    kind_s, its, nfacet, *sargs = chip_smoke.capture_call(constraint_batched, "solve_core",
                                                          lambda: step.forward(m, d))
    *head, Minv, qs, x0 = sargs
    ci = constraint_batched.row_inputs(kind_s, nfacet, *head)
    return (lambda k: (ci["kind"], k, nfacet, ci["rows"], ci["maps"], ci["qM"], Minv, ci["qvel"],
                       qs, x0)), its


def main() -> int:
    global CG
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--csrc", nargs="*", default=[os.path.join(REPO, "robogym_torch", "csrc")])
    ap.add_argument("--device-j", action="store_true",
                    help="also compare a build of the first sources with F's J in device memory")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("cg_seed_sweep: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from robogym_torch.physics import cg_kernel

    CG = cg_kernel.cg
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {chip_smoke.card_line()}", flush=True)
    world = chip_smoke.worlds()
    first = {}   # (world, kernel) -> (args_of, iterations, outputs) of build 0, seed 0
    with tempfile.TemporaryDirectory() as tmp:
        builds = []
        for i, csrc in enumerate(opts.csrc):
            src = os.path.join(tmp, f"src{i}")
            builds.append((csrc, src, os.path.join(tmp, f"lib{i}"), prepare(csrc, src)))
        swept = len(builds)
        if opts.device_j:
            src = os.path.join(tmp, "device_j")
            builds.append((f"{opts.csrc[0]} (F's J in device memory)", src,
                           os.path.join(tmp, "lib_device_j"), prepare(opts.csrc[0], src)))
            force_device_route(src)
        for i, (csrc, src, lib, scratch) in enumerate(builds[:swept]):
            print(f"[{csrc}] {registers(load(src, lib, scratch))}", flush=True)
            for wname, kernel in WORLDS:
                passes, excused = 0, []
                for seed in range(opts.seeds):
                    args_of, its = capture(chip_smoke, world, wname, kernel, seed)
                    report = {}
                    _, early, noise, failures = chip_smoke.cg_readings(kernel, args_of, its,
                                                                       report)
                    worst = max(e_k / max(e_p, 1e-30) for e_k, e_p in noise.values())
                    passes += not failures
                    envs = sorted({e for e, _, _ in report["excused"]})
                    excused.append(len(envs))
                    print(f"[{csrc} {kernel}@{wname} seed {seed}] "
                          f"{'passes' if not failures else 'FAILS: ' + '; '.join(failures)}: "
                          f"worst ratio of err vs float64 to the plain version's {worst:.3g}, "
                          f"largest early error "
                          f"{max(max(e.values()) for e in early.values()):.3g}; envs excused "
                          f"on ties {len(envs)} ({len(report['excused'])} forced choices"
                          + "".join(f"; {chip_smoke.witness_text(*w)}"
                                    for w in report["excused"][:12]) + ")", flush=True)
                    if i == 0 and seed == 0:
                        first[wname, kernel] = (args_of, its, [
                            o.clone() for o in chip_smoke.wrapper(kernel)(*args_of(its))])
                print(f"[{csrc} {kernel}@{wname}] {passes} of {opts.seeds} seeds pass; envs "
                      f"excused on ties per seed {excused}", flush=True)
        for build in builds[1:]:
            if build[0] not in opts.csrc:
                print(f"[{build[0]}] {registers(load(*build[1:]))}", flush=True)
            for (wname, kernel), (args_of, its, want) in first.items():
                load(*build[1:])
                a = args_of(its)
                same = all(torch.equal(g, w) for g, w in zip(chip_smoke.wrapper(kernel)(*a), want))
                t = []
                for b in (builds[0], build, build, builds[0]):
                    load(*b[1:])
                    fn = chip_smoke.wrapper(kernel)
                    t.append(chip_smoke.timed_ms(lambda: fn(*a), chip_smoke.REPS))
                print(f"[{build[0]} {kernel}@{wname} seed 0] outputs on {opts.csrc[0]}'s inputs: "
                      f"{'bit-identical' if same else 'DIFFER'}; ms in turns (first build, this, "
                      "this, first): " + " / ".join(f"{x:.4f}" for x in t), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
