#!/usr/bin/env python3
"""Hold the CG kernels to chip_smoke.py's checks on several seeded start
states of each world, for one or more builds of the kernel sources, and
compare the builds' outputs bit for bit.

    python3 tools/cg_seed_sweep.py [--seeds N] [--only WORLD:SEED,...] [--csrc DIR ...]
                                   [--device-j]

Runs on an NVIDIA GPU. For each source directory (the checkout's
`robogym_torch/csrc` by default; another checkout's, for example a parent
commit unpacked with `git archive`, to compare), it builds the kernel
library into a temporary directory, then for each world and each seed
0..N-1 settles seeded start states at B=1024 through the port's step (so
through that build's kernels), captures a CG kernel's inputs from one more
substep or call as chip_smoke.py does, and runs `chip_smoke.cg_readings`:
the plain version forced through the float32 ties where the kernel parts
from it (no env may leave it within the early iterations otherwise), 1e-4
relative after 1 and 2 iterations, and the one-step check (each of the 15
iterations from the kernel's own traced state, `one_step_readings`); after
15, each output's error against a float64 run beside 2 times the plain
version's (the noise check) is counted, not held. Kernel B (`cg_full`) on the goal-settle,
locked-like and table worlds and on the chessboard's and the mixture's
states (the env built once, its generator seeded, reset, and B's inputs
from one env step), B without the Euler update (`cg_full_noeuler`, one
`forward()`) on the locked-like world, and F (`cg`) on the hand world.
Each state prints the envs excused on ties and the first witnesses.
It prints each build's CG kernel instances with their registers and
spills, each state's verdict (a failure names its env, iteration and
field) with its worst one-step error over its tolerance, the envs excused
on a pick tie at a step and its worst ratio of the kernel's error against
float64 to the plain version's, and per world the seeds that pass and
those whose noise check would have passed.

For a state that fails, it also prints why: the envs whose inputs are
not finite (for a mesh-family env, also those that the same env step
leaves non-finite through the plain versions alone), and for each env
that leaves within the early iterations `setup_diagnosis`, its
set-up's gradient against the plain version's in units of the rounding of
the magnitudes summed into it, how far that gradient cancels, the cosine
of the two search directions and the difference after one iteration.
`--only` sweeps the named world and seed pairs alone (each world's
kernels of `WORLDS`).

Then, on the seed-0 inputs that the first build's states gave, it runs
every other build's kernels, says whether their outputs after 15
iterations equal the first build's bit for bit, and times each kernel for
the first build and the other in turns (first, other, other, first;
`chip_smoke.timed_ms`). `--device-j` adds to these comparisons, and to
no sweep, a build of the first source directory whose kernel F always
keeps J in device memory (its size route), so that F's two routes are
compared on the hand world's inputs.

Another source directory is loaded through `chip_smoke.build_of`: a
build from before the CG trace is called without its pointer. Builds
whose kernel F takes no scratch buffer, or that export no layout sizes,
are not loaded.
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
WORLDS = (("settle", "cg_full"), ("locked_like", "cg_full"), ("locked_like", "cg_full_noeuler"),
          ("table", "cg_full"), ("hand", "cg"), ("chessboard", "cg_full"), ("mixture", "cg_full"))
# the mesh-family envs among WORLDS: their states come from an env's reset
FAMILY_ENVS = ("chessboard", "mixture")


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


def nonfinite_envs(x, B) -> set:
    """The envs (rows of the leading batch axis B) with a non-finite value
    anywhere in a CG kernel's arguments `x`."""
    if isinstance(x, torch.Tensor):
        if x.dim() == 0 or x.shape[0] != B or not x.is_floating_point():
            return set()
        return set((~torch.isfinite(x)).reshape(B, -1).any(-1).nonzero()[:, 0].tolist())
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (tuple, list)):
        return set().union(*[nonfinite_envs(v, B) for v in x]) if x else set()
    return set()


def setup_diagnosis(chip_smoke, name, args_of, envs):
    """Why envs leave the plain version within the early iterations: for
    each env, the kernel's set-up and first iteration (its trace) against
    the plain version's on the same inputs. Per env: the largest
    difference of the set-up's g over the float32 rounding unit of the
    magnitudes that reach each entry (2^-23 x (|M| |x - qs| + |J|^T (D
    (|J| |x| + |aref|))): the rows' forces carry the rounding of jar times
    their weight D), the cosine of the two search directions, the two first
    steps a and the Newton step's slope phi'(0) = c1 + f.Jp of the plain
    set-up over the magnitudes summed into it (how far it cancels), and
    the largest difference of x after one iteration over the batch's
    largest |x|. Returns [dict] by env."""
    from robogym_torch.physics.smooth import mv

    a0, a1 = args_of(0), args_of(1)
    *outs, tr = chip_smoke.wrapper(name)(*a1, trace=True)
    setup, trace = [], []
    chip_smoke.forced_plain(name, a1, states=setup, trace=trace)
    p0 = setup[0]
    J, aref, Deq, Done, Dfr, floss, M, _, qs = chip_smoke.solve_system(name, a0, outs)
    Ja = J.abs()
    f_mag = (Deq + Done + Dfr) * (mv(Ja, p0["x"].abs()) + aref.abs())
    g_mag = mv(M.abs(), (p0["x"] - qs).abs()) + mv(Ja.transpose(-1, -2), f_mag)
    scale = float(setup[1]["x"].abs().max())
    out = []
    for env in envs:
        dg = (tr["g"][env, 0] - p0["g"][env]).abs().double()
        pk, pp = tr["p"][env, 0].double(), p0["p"][env].double()
        cos = float((pk * pp).sum() / (pk.norm() * pp.norm()).clamp_min(1e-300))
        a_k = float(((tr["x"][env, 1] - tr["x"][env, 0]).double() * pk).sum() / (pk * pk).sum())
        dx, p = (p0["x"][env] - qs[env]).double(), pp
        Jp, Mp = J[env].double() @ p, M[env].double() @ p
        jar = p0["jar"][env].double()
        f = Deq[env] * jar + Done[env] * jar * (jar < 0) + torch.clamp(
            Dfr[env] * jar, -floss[env].double(), floss[env].double())
        phi = float((dx * Mp).sum() + (f * Jp).sum())
        phi_mag = float((dx.abs() * Mp.abs()).sum() + (f.abs() * Jp.abs()).sum())
        out.append(dict(env=env, g_units=float((dg / (chip_smoke.F32_EPS * g_mag[env].double()
                                                           .clamp_min(1e-30))).max()),
                        direction_cos=cos, step_kernel=a_k,
                        step_plain=float(trace[0]["step"][env]),
                        slope_cancel=abs(phi) / max(phi_mag, 1e-300),
                        x1_rel=float((tr["x"][env, 1] - setup[1]["x"][env]).abs().max())
                        / max(scale, 1e-30)))
    return out


def nan_origin(chip_smoke, wname, seed, envs, label):
    """Where a mesh-family env's reset and env step (as `capture` runs
    them) first leave envs `envs` non-finite through the kernels: every
    kernel call is recorded for those envs, and the first that takes
    finite inputs and gives non-finite outputs is run again on those
    inputs through the kernel and through its plain version; where inputs
    turn non-finite with no kernel output non-finite before them, the
    plain PyTorch between the kernels is named."""
    import importlib

    env = family_env(chip_smoke, wname)
    env.generator.manual_seed(seed)
    B = chip_smoke.BATCH
    idx = torch.as_tensor(envs, device=env.device)
    events = []

    def bad(x, n):
        return bool(nonfinite_envs(x, n))

    def recorder(name, fn):
        def rec(*args, **kw):
            out = fn(*args, **kw)
            n = args[0].shape[0] if isinstance(args[0], torch.Tensor) else args[5].shape[0]
            if n == B:
                sub = chip_smoke.take_envs(list(args), idx, B)
                events.append((name, bad(sub, len(envs)),
                               bad(chip_smoke.take_envs(list(out), idx, B), len(envs)), sub))
            return out
        return rec

    subs = [((importlib.import_module(k["module"]), name),
             recorder(name, getattr(importlib.import_module(k["module"]), name)))
            for name, k in chip_smoke.KERNELS.items()]
    with chip_smoke.patched(subs):
        state, _ = env.reset(B)
        phase = "reset"
        if not bad(chip_smoke.take_envs([state.physics.qpos, state.physics.qvel], idx, B),
                   len(envs)):
            phase = "env step"
            events.clear()
            env.step(state, chip_smoke.rearrange_actions(env, B)())
    for n, (name, bad_in, bad_out, sub) in enumerate(events):
        if bad_in:
            print(f"[{label}] why: envs {envs}: in the {phase}, kernel call {n} ({name}) of "
                  f"{len(events)} is the first to take non-finite inputs, and no kernel gave a "
                  "non-finite output before it: the plain PyTorch between the kernels (the "
                  "smooth phase, the collision, the constraint rows) made them", flush=True)
            return
        if bad_out:
            got = chip_smoke.wrapper(name)(*sub)
            want = chip_smoke.wrapper(name, plain=True)(*sub)
            fin = lambda outs: [bool(torch.isfinite(o).all()) for o in outs]  # noqa: E731
            print(f"[{label}] why: envs {envs}: in the {phase}, kernel call {n} ({name}) of "
                  f"{len(events)} takes finite inputs and gives non-finite outputs; on those "
                  f"inputs alone its outputs are finite through the kernel {fin(got)}, through "
                  f"its plain version {fin(want)}", flush=True)
            return
    print(f"[{label}] why: envs {envs}: no kernel call of the {phase} gave a non-finite output",
          flush=True)


def diagnose(chip_smoke, world, wname, kernel, seed, args_of, report, label):
    """Print why a failing state fails (see the module's doc)."""
    a = args_of(1)
    B = (a[0] if kernel == "cg" else a[5]).shape[0]
    bad = sorted(nonfinite_envs(a, B))
    line = f"[{label}] why: envs with non-finite inputs {bad[:16]} ({len(bad)})"
    if wname in FAMILY_ENVS and bad:
        with chip_smoke.plain_versions():
            pa = capture(chip_smoke, world, wname, kernel, seed)[0](1)
        plain_bad = sorted(nonfinite_envs(pa, B))
        line += f"; through the plain versions alone {plain_bad[:16]} ({len(plain_bad)})"
        print(line, flush=True)
        if set(bad) - set(plain_bad):
            nan_origin(chip_smoke, wname, seed, sorted(set(bad) - set(plain_bad))[:4], label)
    else:
        print(line, flush=True)
    early = sorted({env for env, _, _ in report["named"] if env not in bad})
    for d in setup_diagnosis(chip_smoke, kernel, args_of, early[:8]):
        print(f"[{label}] why: env {d['env']} leaves within the early iterations: its set-up "
              f"g differs from the plain version's by up to {d['g_units']:.3g} x 2^-23 of the "
              f"magnitudes that reach an entry; search directions' cosine "
              f"{d['direction_cos']:.9f}; first steps {d['step_kernel']:.6g} (kernel) and "
              f"{d['step_plain']:.6g} (plain), the slope phi'(0) {d['slope_cancel']:.3g} of the "
              f"magnitudes summed into it; x after one iteration off by {d['x1_rel']:.3g} of "
              f"the batch's largest |x|", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, default=8)
    ap.add_argument("--only", default="", help="comma-separated WORLD:SEED pairs to sweep alone")
    ap.add_argument("--csrc", nargs="*", default=[os.path.join(REPO, "robogym_torch", "csrc")])
    ap.add_argument("--device-j", action="store_true",
                    help="also compare a build of the first sources with F's J in device memory")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("cg_seed_sweep: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {chip_smoke.card_line()}", flush=True)
    world = chip_smoke.worlds()
    first = {}   # (world, kernel) -> (args_of, iterations, outputs) of build 0, seed 0
    with tempfile.TemporaryDirectory() as tmp:
        builds = []   # (label, sources, library directory)
        for i, csrc in enumerate(opts.csrc):
            src = os.path.join(tmp, f"src{i}")
            shutil.copytree(csrc, src)
            builds.append((csrc, src, os.path.join(tmp, f"lib{i}")))
        swept = len(builds)
        if opts.device_j:
            src = os.path.join(tmp, "device_j")
            shutil.copytree(opts.csrc[0], src)
            force_device_route(src)
            builds.append((f"{opts.csrc[0]} (F's J in device memory)", src,
                           os.path.join(tmp, "lib_device_j")))
        for i, (csrc, src, lib) in enumerate(builds[:swept]):
            with chip_smoke.build_of(src, lib):
                from robogym_torch import cuda

                print(f"[{csrc}] {registers(cuda.build())}", flush=True)
                only = [tuple(p.split(":")) for p in opts.only.split(",") if p]
                for wname, kernel in WORLDS:
                    seeds = ([int(sd) for w, sd in only if w == wname] if only
                             else range(opts.seeds))
                    if not seeds:
                        continue
                    passes, quiet, excused = 0, 0, []
                    for seed in seeds:
                        args_of, its = capture(chip_smoke, world, wname, kernel, seed)
                        report = {}
                        _, early, noise, failures = chip_smoke.cg_readings(kernel, args_of, its,
                                                                           report)
                        worst = max(e_k / max(e_p, 1e-30) for e_k, e_p in noise.values())
                        quiet += all(e_k <= chip_smoke.NOISE_RATIO * e_p + 1e-6
                                     for e_k, e_p in noise.values())
                        passes += not failures
                        step = report["one_step"]
                        envs = sorted({e for e, _, _ in report["excused"]})
                        stepped = sorted({e for e, _, _ in step["excused"]})
                        excused.append((len(envs), len(stepped)))
                        print(f"[{csrc} {kernel}@{wname} seed {seed}] "
                              f"{'passes' if not failures else 'FAILS: ' + '; '.join(failures)}: "
                              "one-step worst error / tolerance " + ", ".join(
                                  f"{f} {w:.3g} (step {k})" for f, (w, k) in step["worst"].items())
                              + f"; envs excused on a pick tie at a step {len(stepped)}"
                              + "".join(f"; {chip_smoke.witness_text(*w)}"
                                        for w in step["excused"][:6])
                              + f"; largest early error "
                              f"{max(max(e.values()) for e in early.values()):.3g}; envs excused "
                              f"on ties by the early check {len(envs)} "
                              f"({len(report['excused'])} forced choices); noise check "
                              f"(reported): worst ratio of err vs float64 to the plain version's "
                              f"{worst:.3g}", flush=True)
                        if failures:
                            diagnose(chip_smoke, world, wname, kernel, seed, args_of, report,
                                     f"{csrc} {kernel}@{wname} seed {seed}")
                        if i == 0 and seed == 0:
                            first[wname, kernel] = (args_of, its, [
                                o.clone() for o in chip_smoke.wrapper(kernel)(*args_of(its))])
                    print(f"[{csrc} {kernel}@{wname}] {passes} of {len(seeds)} seeds pass; the "
                          f"noise check would pass {quiet}; envs excused per seed (early check, "
                          f"one-step) {excused}", flush=True)
        for build in builds[1:]:
            with chip_smoke.build_of(*build[1:]):
                from robogym_torch import cuda

                if build[0] not in opts.csrc:
                    print(f"[{build[0]}] {registers(cuda.build())}", flush=True)
                for (wname, kernel), (args_of, its, want) in first.items():
                    a = args_of(its)
                    same = all(torch.equal(g, w)
                               for g, w in zip(chip_smoke.wrapper(kernel)(*a), want))
                    print(f"[{build[0]} {kernel}@{wname} seed 0] outputs on {opts.csrc[0]}'s "
                          f"inputs: {'bit-identical' if same else 'DIFFER'}", flush=True)
            for (wname, kernel), (args_of, its, want) in first.items():
                a = args_of(its)
                t = []
                for b in (builds[0], build, build, builds[0]):
                    with chip_smoke.build_of(*b[1:]):
                        fn = chip_smoke.wrapper(kernel)
                        t.append(chip_smoke.timed_ms(lambda: fn(*a), chip_smoke.REPS))
                print(f"[{build[0]} {kernel}@{wname} seed 0] ms in turns (first build, this, "
                      "this, first): " + " / ".join(f"{x:.4f}" for x in t), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
