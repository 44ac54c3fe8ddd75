#!/usr/bin/env python3
"""Time kernel A (`robogym_torch/csrc/spd_inverse.cu`) of two builds in
turns on the same operands, compare their outputs bit for bit, and read
what the compiler made of each build.

    python3 tools/spd_turns.py [--parent DIR ...] [--variants] [--seeds 0,1,2,3]
                               [--dense V,...] [--out DIR]

Runs on an NVIDIA GPU. Captures kernel A's operands at B=1024 as
chip_smoke.py does: M of one locked-like substep (`A`, V=30; also M + dt *
diag(damping), `A/Mimp`, the second launch of the same substep), of one
hand-world substep (`A@hand`, V=24), of the wide synthetic system
(`A@wide`, V=96, `chip_smoke.wide_core_inputs`) and dense seeded SPD
matrices at HUGE_V (`A@huge`, V=160, `chip_smoke.dense_spd`), both on the
block kernel in shared memory. `--dense` adds dense seeded SPD matrices at
each V it names (`A@denseV`).

It builds the checkout's `robogym_torch/csrc/` and, for each `--parent`, a
copy of it whose spd_inverse.cu is DIR's (for example the parent commit's,
taken out with `git show`), each into a temporary directory and named by
DIR's last component. For each build it prints kernel A's registers and
spills (`nvcc -Xptxas -v`), the layout the build reports where it exports
`robogym_spd_inverse_info` (`chip_smoke.spd_layout`: route, warps and
shared memory a block, envs and warps an SM, waves),
and the SASS of each instance (`cuobjdump -sass`): its instructions,
shuffles, shared loads and stores, global loads and stores, block
barriers and float operations (listings in OUT/spd_sass_<build>.txt,
OUT by default the checkout's ignored build/sass); then each entry's
times at B/2, B and 2B (the operands sliced to 512 and repeated to 2048
envs). For each `--parent`, it says whether each register instance
(`spd_inverse_kernel<Vp>`, up to 64 dofs) has the same SASS counts and
the same SASS text, instruction for instruction, in both builds.

`--variants` adds four copies of the checkout's spd_inverse.cu as if
each were a `--parent`: `ieee`, with the square roots and divisions as
sqrtf and '/' (nvcc's IEEE forms with their range checks and slow-path
calls), and `stop_load`, `stop_chol`, `stop_fwd`, which write out the
registers they hold and return after the load, the Cholesky and the forward
substitution: where the time goes, stage by stage.

For each `--parent` and variant, each entry's outputs of that build and of
the checkout's are compared (`torch.equal`, and the envs that differ;
each build writes into a tensor filled with NaN, so that an output it
leaves unwritten never reads as equal), and the two are timed in turns at
B/2, B and 2B: DIR, checkout, checkout, DIR (`chip_smoke.timed_ms`).

Last, the checkout's build is held to `chip_smoke.spd_readings` (1e-5 of
the plain version's largest entry; per column against a float64 inverse,
at most SPD_COLUMN_RATIO times the plain version's) on the locked-like and
hand worlds' M from start states of each seed of `--seeds`, and on the
wide and huge operands once; the script exits non-zero if a reading fails
or a `--parent`'s outputs or register instances' SASS differ from the
checkout's.
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

KEY = "spd_inverse"
COUNTS = ("instructions", "shfl", "lds", "sts", "ldg", "stg", "bar", "fp")
# where a truncated copy stops, and the registers it writes out
STOPS = {"stop_load": ("  // right-looking Cholesky", "a"),
         "stop_chol": ("  // forward substitution L X = I", "a"),
         "stop_fwd": ("  // X^T by rows over L's tile", "x")}
IEEE = {"  return fmaf(fmaf(-s, s, x), h, s);": "  return sqrtf(x);",
        "  return fmaf(r, fmaf(q, -b, a), q);": "  return a / b;"}


def variants(tmp):
    """{name: path} of the `--variants` copies of the checkout's source."""
    with open(os.path.join(hull_turns.CSRC, "spd_inverse.cu")) as f:
        src = f.read()
    out = {}
    texts = {"ieee": src}
    for old, new in IEEE.items():
        if src.count(old) != 1:
            raise RuntimeError(f"variant ieee: {old!r} is not found once")
        texts["ieee"] = texts["ieee"].replace(old, new)
    for name, (marker, regs) in STOPS.items():
        if src.count(marker) != 1:
            raise RuntimeError(f"variant {name}: {marker!r} is not found once")
        texts[name] = src.replace(marker, f"""#pragma unroll
  for (int r = 0; r < Vp; ++r) if (t < Vp) S[r * SS + t] = {regs}[0][r];
  __syncwarp();
  {{
    float* ob = out + (size_t)b * V * V;
    for_block<kPer>(V, t, 0, [&](int, int e, int r, int c) {{ ob[e] = S[r * SS + c]; }});
  }}
  return;
""" + marker)
    for name, text in texts.items():
        os.makedirs(os.path.join(tmp, "src_" + name))
        out[name] = os.path.join(tmp, "src_" + name, "spd_inverse.cu")
        with open(out[name], "w") as f:
            f.write(text)
    return out


def capture(chip_smoke, seed, dense=()):
    """{entry: (B, V, V) operand} at B=1024 from start states of `seed`
    (the wide, huge and `dense` operands from chip_smoke's own seed)."""
    from robogym_torch.physics import constraint_batched, factor_kernel, step

    world = chip_smoke.worlds()
    out = {}
    m, arrays, kw = world["locked_like"]
    d = chip_smoke.start_states(m, arrays, chip_smoke.BATCH, seed, **kw)
    qM, Mimp = chip_smoke.capture_calls(factor_kernel, "spd_inverse", lambda: step.step(m, d))
    out["A"], out["A/Mimp"] = qM[0], Mimp[0]
    m, arrays, kw = world["hand"]
    d = chip_smoke.start_states(m, arrays, chip_smoke.BATCH, seed, **kw)
    out["A@hand"] = chip_smoke.capture_call(factor_kernel, "spd_inverse",
                                            lambda: step.step(m, d))[0]
    if seed == chip_smoke.SEED:
        kind_s, _, nfacet, args = chip_smoke.wide_core_inputs(chip_smoke.BATCH)
        out["A@wide"] = constraint_batched.core_inputs(
            kind_s, nfacet, *[torch.as_tensor(a, device="cuda") for a in args])["qM"]
        out["A@huge"] = chip_smoke.dense_spd(chip_smoke.BATCH, chip_smoke.HUGE_V, "cuda")
        for V in dense:
            out[f"A@dense{V}"] = chip_smoke.dense_spd(chip_smoke.BATCH, V, "cuda")
    return out


def sizes(A):
    """A at B/2, B and 2B envs."""
    return {"B/2": A[: A.shape[0] // 2].contiguous(), "B": A, "2B": torch.cat([A, A]).contiguous()}


def report_build(name, so, log, out):
    """Print a build's registers and SASS counts; returns the counts."""
    print(f"[{name}] built {so}")
    for fn, (regs, st, ld) in hull_turns.registers(log, KEY).items():
        print(f"  {fn}: {regs} registers, spill stores {st} B, loads {ld} B")
    counts = hull_turns.sass(so, os.path.join(out, f"spd_sass_{name}.txt"), KEY)
    for fn, s in counts.items():
        print(f"  SASS {fn}: {s['instructions']} instructions, SHFL {s['shfl']}, LDS {s['lds']}, "
              f"STS {s['sts']}, LDG {s['ldg']}, STG {s['stg']}, BAR {s['bar']}, "
              f"FMUL/FADD/FFMA/FMNMX {s['fp']}, loops {len(s['loops'])}")
        for start, end, n, shfl, lds, fp in s["loops"]:
            print(f"    loop {start:#06x}-{end:#06x}: {n} instructions, SHFL {shfl}, LDS {lds}, "
                  f"FMUL/FADD/FFMA/FMNMX {fp}")
    return counts


def report_sass_equal(other, counts):
    """Whether each register instance has the same SASS counts and text in
    build `other` as in the checkout's; returns the instances that
    differ."""
    bad = []
    for fn in sorted(f for f in counts["checkout"] if "spd_inverse_kernel<" in f):
        mine, theirs = counts["checkout"][fn], counts[other].get(fn)
        same = theirs is not None and all(mine[k] == theirs[k] for k in COUNTS)
        text = theirs is not None and mine["listing"] == theirs["listing"]
        first = next((i for i, (a, b) in enumerate(zip(mine["listing"], theirs["listing"]))
                      if a != b), None) if theirs is not None and not text else None
        print(f"[sass {other}] {fn}: counts {'equal' if same else 'DIFFER'}, text "
              f"{'identical' if text else 'DIFFERS'}"
              + (f" (first at instruction {first})" if first is not None else "") + " ("
              + ", ".join(f"{k} {mine[k]}/{theirs[k] if theirs else '-'}" for k in COUNTS) + ")")
        if not (same and text):
            bad.append(fn)
    return bad


def laid_out(ops):
    """The entries laid out and scaled: all but `A/Mimp` (A's V)."""
    return [e for e in ops if e != "A/Mimp"]


def report_layout(chip_smoke, name, ops):
    """The layout the loaded build reports, if it exports it."""
    for entry in laid_out(ops):
        B, V, _ = ops[entry].shape
        try:
            chip_smoke.spd_layout(f"{name}] [{entry}", B, V)
        except AttributeError:
            return


def report_scaling(chip_smoke, name, ops):
    from robogym_torch.physics import factor_kernel as fk

    for entry in laid_out(ops):
        t = {k: chip_smoke.timed_ms(lambda x=x: fk.spd_inverse(x), chip_smoke.REPS)
             for k, x in sizes(ops[entry]).items()}
        print(f"[{name}] {entry} at B/2, B, 2B: " + " / ".join(f"{x:.4f}" for x in t.values())
              + f" ms; ratios to B/2: 1 / {t['B'] / t['B/2']:.2f} / {t['2B'] / t['B/2']:.2f}")


def report_turns(chip_smoke, other, builds, ops):
    """Each entry of build `other` against the checkout's: outputs bit for
    bit, then times in turns (other, checkout, checkout, other)."""
    from robogym_torch import cuda
    from robogym_torch.physics import factor_kernel as fk

    differ = []
    for entry, A in ops.items():
        got = {}
        for name in (other, "checkout"):
            cuda._lib = builds[name]
            got[name] = torch.full_like(A, float("nan"))
            cuda.launch("spd_inverse", A, got[name], A.shape[0], A.shape[1])
        torch.cuda.synchronize()
        a, b = got[other], got["checkout"]
        off = int((a != b).flatten(1).any(1).sum())
        print(f"[turns {other}] {entry}: outputs equal to the checkout's: {torch.equal(a, b)} "
              f"({off} envs differ, max abs diff {float((a - b).abs().max()):.3g})")
        if not torch.equal(a, b):
            differ.append(f"{other} {entry}")
        for size, x in sizes(A).items():
            t = []
            for name in (other, "checkout", "checkout", other):
                cuda._lib = builds[name]
                t.append(chip_smoke.timed_ms(lambda: fk.spd_inverse(x), chip_smoke.REPS))
            print(f"[turns {other}] {entry} at {size} (B={x.shape[0]}): {other} / checkout / "
                  f"checkout / {other}: " + " / ".join(f"{v:.4f}" for v in t)
                  + f" ms; {other} / checkout {(t[0] + t[3]) / (t[1] + t[2]):.2f}")
    return differ


def report_seeds(chip_smoke, seeds, ops0):
    """chip_smoke.spd_readings on each seed's operands; returns failures."""
    bad = []
    for seed in seeds:
        ops = ops0 if seed == chip_smoke.SEED else capture(chip_smoke, seed)
        for entry in ("A", "A/Mimp", "A@hand"):
            r, failures = chip_smoke.spd_readings(ops[entry])
            print(f"[seed {seed}] {entry}: rel err {r['max_err']:.3g} (tol {chip_smoke.SPD_TOL}); "
                  f"per-column err vs float64 {r['column']:.3g}, plain version's "
                  f"{r['plain_column']:.3g}, ratio {r['column'] / r['plain_column']:.2f} (at most "
                  f"{chip_smoke.SPD_COLUMN_RATIO}); bit-symmetric {r['symmetric']}"
                  + (f"; FAILS: {'; '.join(failures)}" if failures else ""))
            bad += [f"seed {seed} {entry}: {f}" for f in failures]
    for entry in ("A@wide", "A@huge"):
        r, failures = chip_smoke.spd_readings(ops0[entry])
        print(f"[{entry}] rel err {r['max_err']:.3g} (tol {chip_smoke.SPD_TOL}); per-column err "
              f"vs float64 {r['column']:.3g}, plain version's {r['plain_column']:.3g}; "
              f"bit-symmetric {r['symmetric']}" + (f"; FAILS: {'; '.join(failures)}"
                                                   if failures else ""))
        bad += [f"{entry}: {f}" for f in failures]
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR", action="append", default=[],
                    help="a directory holding another spd_inverse.cu (may be given again)")
    ap.add_argument("--variants", action="store_true",
                    help="also the IEEE-operator and stage-truncated copies of the source")
    ap.add_argument("--seeds", default="0,1,2,3", help="seeds of the readings, comma-separated")
    ap.add_argument("--dense", default="", help="dofs of dense seeded entries, comma-separated")
    ap.add_argument("--out", default=os.path.join(REPO, "build", "sass"),
                    help="where the SASS listings go (about 23 MB a build)")
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("spd_turns: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke
    from robogym_torch import cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {chip_smoke.card_line()}", flush=True)
    others = {os.path.basename(os.path.normpath(d)): os.path.join(d, "spd_inverse.cu")
              for d in opts.parent}
    with tempfile.TemporaryDirectory() as tmp:
        if opts.variants:
            others.update(variants(tmp))
        builds, counts = {}, {}
        for name, src in [*others.items(), ("checkout", None)]:
            builds[name], so, log = hull_turns.build(tmp, name, src, "spd_inverse.cu")
            counts[name] = report_build(name, so, log, opts.out)
        parents = [name for name in others if name not in ("ieee", *STOPS)]
        bad = [f"{other} {fn}: SASS counts differ" for other in parents
               for fn in report_sass_equal(other, counts)]
        cuda._lib = builds["checkout"]
        ops = capture(chip_smoke, chip_smoke.SEED, [int(v) for v in opts.dense.split(",") if v])
        for entry, A in ops.items():
            print(f"[operands] {entry}: B={A.shape[0]} V={A.shape[1]}")
        for name, lib in builds.items():
            cuda._lib = lib
            report_layout(chip_smoke, name, ops)
            report_scaling(chip_smoke, name, ops)
        for other in others:
            differ = report_turns(chip_smoke, other, builds, ops)
            if other in parents:
                bad += [f"{d}: outputs differ" for d in differ]
        cuda._lib = builds["checkout"]
        bad += report_seeds(chip_smoke, [int(s) for s in opts.seeds.split(",") if s], ops)
    print("spd_turns: " + (f"fails: {bad}" if bad else "every reading passes; every --parent's "
                           "outputs and register instances equal the checkout's"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
