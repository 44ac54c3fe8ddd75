#!/usr/bin/env python3
"""Plant faults in the SPD inverse (A, `spd_inverse.cu`), in the CG kernels
(B, `cg_full.cu`; F, `cg.cu`; their shared loop in `cg_common.cuh`), in the
box-box kernel (E, `boxbox.cu`), in the world-vertex branch of the hull
kernels (G and H, `hull_sweep.cu`), in the sweep that the hull kernels
share (C, D, G and H) and in the hull pair's epilogue (D and G), and show
whether the checks that `chip_smoke.py` holds each kernel to catch them.

    python3 tools/cg_fault_check.py [--faults NAME,...]

(`--faults` runs the sound build and the named faults only.)

Runs on an NVIDIA GPU. It captures each kernel's inputs as `chip_smoke.py`
does, at B=1024: A's from one substep of the locked-like world (M, V=30),
of the hand-only world (V=24) and of the dactyl-shaped world (V=36), dense
seeded SPD matrices (V=36; V=160, one env a block with the matrix in
shared memory; V=256, the same block body in device memory) and the wide
system's M (V=96), B's from one substep of the locked-like
world and, with each env's own timestep, from one step of the default
dactyl wrapper stack around the locked env (`cg_full@dt`), and from the
rearrange env's solver sim in one env step from its reset state, with its
weld, connect and joint rows (`cg_full@solver`), F's from one substep of
the hand-only world (J in shared memory) and
from chip_smoke's wide system (`cg_wide`: V=96, E=408, J in device memory),
E's from one substep of the goal-settle world, C's and D's from the
locked-like substep's hull winners and C's also from the table world's two
manifold calls (`@table-box`, `@table`), G's and H's from the locked-like
substep's hull winners placed in the world. Then, for the sound sources
and for each fault below, it copies
`robogym_torch/csrc/` into a temporary directory, plants the fault in the
copy (the checkout's sources are never changed), builds the copy there, and
prints the readings of `chip_smoke.cg_readings`,
`chip_smoke.boxbox_readings`, `chip_smoke.hull_readings` (for G and H
with `chip_smoke.world_vs_local`) or `chip_smoke.spd_readings` for it and
whether the check passes, and for A which of its checks fails; for a CG
kernel, which of its three held parts fails: an env that leaves the plain
version (forced through float32 ties where the kernel parts from it)
within the early iterations with no tie to explain it, the early check
(1e-4 after 1 and 2 iterations) or the one-step check (each iteration
from the kernel's own traced state, `chip_smoke.one_step_readings`: the
field and iteration that fail), and the noise check after all of them
(the kernel's error against a float64 run beside 2 times the plain
version's), which is reported and holds nothing. The sound sources must
pass every check and each fault must fail the checks of its kernels, and
pass those that `PASSES` names for it; otherwise the script exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MANIFOLD = ("hull_manifold", "hull_manifold@table-box", "hull_manifold@table",
            "hull_manifold_world")
# A's register instances (V=30, the hand's V=24, the locked env's V=36 at
# two rows a lane and dense seeded SPD matrices at V=36,
# `chip_smoke.dense_spd`), then its block kernel above 64 dofs: in shared
# memory at V=96 and V=160, in device memory at V=256
SPD_REG = ("spd_inverse", "spd_inverse@hand", "spd_inverse@dactyl", "spd_inverse@dense36")
SPD_BLOCK = ("spd_inverse@wide", "spd_inverse@huge", "spd_inverse@dev")
SPD = SPD_REG + SPD_BLOCK
PAIR = ("hull_pair", "hull_pair_world")
CHECKED = SPD + ("cg_full", "cg_full@dt", "cg_full@solver", "cg", "cg_wide", "boxbox") + PAIR \
    + MANIFOLD
RANK1 = "if (c4 + m > j) a[k][c4 + m] -= l[k] * lc[m];"
DIAG = "__shfl_sync(kFull, a[j / 32][j], j % 32)"
PAD = "a[k][c] = (c == i) ? 1.0f : 0.0f;  // identity on the padded dofs"
SLOT = "if (c4 >= 32 * (k + 1)) continue;"
SMEM_DIAG = "const float dj = sqrt_rn(fmaxf(Lj[j], 1e-20f));"
DEV_SCRATCH = "float* T = scratch + (size_t)b * matrix_floats(V);"
PANEL = """      for (int j = j0; j < j1; ++j) {
        const float* Lj = T + j * S;
        const float lc = Lj[c];"""
B_DT = "const float dt = p.dt[(size_t)b * p.dt_stride];"
B_JS = "J[(idx - i * V) * CS + i] = p.Js[(size_t)b * n_s * V + idx];"
SCALES = "const float scales[4] = {2.0f, 1.0f, 0.5f, 0.125f};"
BETA = "const float beta = fmaxf(nd[0] / fmaxf(nd[1], 1e-12f), 0.0f);"
B_SOLVE = "cg_solve<DPL>(sys, M, Minv, x, qs, p.f + bE, V, Vs, p.iterations, tr);"
F_SOLVE = "cg_solve<DPL>(sys, M, Minv, x, qs, p.f + bE, V, Ms, p.iterations, tr);"
TRACE_STEP = "if (trace) trace_state(trace + (size_t)(it + 1) * T,"
SELECT = """    float best_cost = 0.0f, best_a = 0.0f;
    int best_k = 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float a = a1 * scales[k];
      const float dcost = a * c1 + 0.5f * a * a * c2 + pen[k] - pen0;
      if (dcost < best_cost) {
        best_cost = dcost;
        best_a = a;
        best_k = k;
      }
    }"""
# the line search prefers the larger step wherever two costs lie within 10
# times the check's tie bound (chip_smoke.TIE_ULPS x 2^-23 of the terms
# summed into each cost): no step counts as the smallest, at cost 0 and
# bound 0
WIDE_TIE = 10 * 4 * 2.0 ** -23
TIE_WIDENED = """    float best_cost = 0.0f, best_a = 0.0f, best_b = 0.0f;
    int best_k = 4;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float a = a1 * scales[k];
      const float dcost = a * c1 + 0.5f * a * a * c2 + pen[k] - pen0;
      const float b = %.9gf * (pen0 + pen[k] + fabsf(a * c1) + 0.5f * a * a * c2);
      if (best_a == 0.0f ? dcost < best_cost + b : dcost < best_cost - (b + best_b)) {
        best_cost = dcost;
        best_a = a;
        best_b = b;
        best_k = k;
      }
    }""" % WIDE_TIE
MID = "const V3 mid{0.5f * (r.p1.x + r.p2.x), 0.5f * (r.p1.y + r.p2.y), 0.5f * (r.p1.z + r.p2.z)};"
# name: (file, text in it, its faulty replacement, the kernels whose checks run)
FAULTS = {
    "sound": None,
    # A's rank-1 update leaves out the last column; at V=30 (Vp=32) and at
    # V=36 (Vp=40) that column is padding, whose l_c are 0, so only the
    # hand's V=24 sees it (PASSES)
    "spd_rank1_skips_last_column": ("spd_inverse.cu", RANK1,
                                    RANK1.replace("c4 + m > j)", "c4 + m > j && c4 + m < Vp - 1)"),
                                    ("spd_inverse@hand",)),
    # step 3 of A's Cholesky takes its diagonal from lane 4 (an entry below
    # it); the block kernel above 64 dofs has no shuffle (PASSES)
    "spd_diagonal_from_wrong_lane": ("spd_inverse.cu", DIAG, DIAG.replace("j % 32)",
                                                                          "j == 3 ? 4 : j % 32)"),
                                     SPD_REG),
    # A's padded dofs start at 0, not at the identity: the square root's
    # clamp keeps their factor finite and they are decoupled from the real
    # dofs, so no output moves (and the hand's V=24 has no padding): it
    # passes every check (PASSES)
    "spd_padding_zero": ("spd_inverse.cu", PAD, PAD.replace("(c == i) ? 1.0f : 0.0f", "0.0f"),
                         ()),
    # the rows of the second slot (rows 32 and up, two rows a lane) skip
    # the rank-1 update of step 33; a row a lane has no second slot, and the
    # dactyl-shaped world's rows 30-35 are decoupled and diagonal, so its M
    # leaves that update at zero (PASSES)
    "spd_second_slot_skips_step": ("spd_inverse.cu", SLOT,
                                   SLOT.replace("continue;", "continue;\n        if (k == 1 && j == 33) continue;"),
                                   ("spd_inverse@dense36",)),
    # the diagonal at step 70 off by 1e-4 relative in the arithmetic of
    # the block kernel above 64 dofs (shared and device memory); the
    # register instances do not run it (PASSES)
    "spd_smem_diagonal_scaled": ("spd_inverse.cu", SMEM_DIAG,
                                 SMEM_DIAG.replace("1e-20f));", "1e-20f)) * (j == 70 ? 1.0001f : 1.0f);"),
                                 SPD_BLOCK),
    # the block kernel in device memory gives two envs one scratch slice:
    # they overwrite each other's factors (in bounds); at V=160 the matrix
    # is in shared memory, which the fault does not reach (PASSES)
    "spd_dev_scratch_shared": ("spd_inverse.cu", DEV_SCRATCH,
                               DEV_SCRATCH.replace("(size_t)b *", "(size_t)(b / 2) *"),
                               ("spd_inverse@dev",)),
    # the block kernel's panel update of the trailing triangle leaves out
    # the panel's last column
    "spd_panel_skips_last_column": ("spd_inverse.cu", PANEL, PANEL.replace("j < j1;", "j < j1 - 1;"),
                                    SPD_BLOCK),
    "one_fewer_iteration": ("cg_full.cu", B_SOLVE, B_SOLVE.replace("p.iterations", "p.iterations - 1"),
                            ("cg_full",)),
    # B's Euler update reads the first env's timestep in every env; with one
    # timestep for the batch that is the right one (PASSES)
    "dt_first_env": ("cg_full.cu", B_DT, "const float dt = p.dt[0];", ("cg_full@dt",)),
    # B builds J without the last three equality rows of its input (kind
    # 0), which in the rearrange solver sim are the mocap weld's rotation
    # rows; the locked-like world has no equality row (PASSES)
    "weld_rotation_rows_dropped": ("cg_full.cu", B_JS, B_JS.replace(
        "= p.Js[", "= (p.kind[i] == 0 && p.kind[i + 3] != 0) ? 0.0f : p.Js["),
        ("cg_full@solver",)),
    # in the loop B and F share; the wide system's line search never takes
    # the 0.125 step, so this fault leaves its outputs as they are
    "scale_0.125_dropped": ("cg_common.cuh", SCALES, SCALES.replace("0.125f", "0.5f"),
                            ("cg_full", "cg")),
    # late and in few envs: from iteration 5 on, in one env of 128 (8 at
    # B=1024), the loop B and F share restarts its direction every
    # iteration (its traced beta 0: the one-step check's beta fails); the
    # early check cannot see it, and F's hand-world solves (about two live
    # rows) have converged by then, so F is checked wide
    "late_restart_few_envs": ("cg_common.cuh", BETA,
                              BETA.replace("= fmaxf", "= blockIdx.x % 128 == 0 && it >= 5 "
                                           "? 0.0f : fmaxf"), ("cg_full", "cg_wide")),
    # the line search takes the larger of two steps whose costs lie within
    # 10 times the tie bound of the check (B and F's shared loop): a bound
    # loose enough to excuse this would excuse a fault
    "tie_widened": ("cg_common.cuh", SELECT, TIE_WIDENED,
                    ("cg_full", "cg_full@dt", "cg_full@solver")),
    # the shared loop writes no trace slot at the last iteration: the
    # one-step check refuses the missing trace
    "trace_skips_last_iteration": ("cg_common.cuh", TRACE_STEP,
                                   TRACE_STEP.replace("if (trace)",
                                                      "if (trace && it + 1 < iterations)"),
                                   ("cg_full", "cg")),
    "facet_sign": ("cg_full.cu", "col[k + 1] = Jn - mu * Jt;",
                   "col[k + 1] = Jn + mu * Jt;", ("cg_full",)),
    "cg_one_fewer_iteration": ("cg.cu", F_SOLVE, F_SOLVE.replace("p.iterations", "p.iterations - 1"),
                               ("cg", "cg_wide")),
    # J^T f of J in device memory walks the rows with stride V - 1 (in bounds)
    "cg_device_j_row_stride": ("cg.cu", "jt_times<DPL>(J, fs, E, V, 1, V, out);",
                               "jt_times<DPL>(J, fs, E, V, 1, V - 1, out);", ("cg_wide",)),
    # corner 6 of each box (candidates 6 and 14) with its z sign flipped
    "boxbox_corner_sign": ("boxbox.cu", "(c & 1) ? 1.0f : -1.0f};",
                           "(c & 1) || (c & 7) == 6 ? 1.0f : -1.0f};", ("boxbox",)),
    # the box-box group argmin breaks exact ties of the SAT depth to the
    # higher axis index
    "boxbox_argmin_ties_high": ("boxbox.cu", "return v < ov || (v == ov && i < oi);",
                                "return v < ov || (v == ov && i > oi);", ("boxbox",)),
    # the box-box staged store writes every warp's pairs one pair early
    # (the first warp's in place, so that nothing is written out of bounds)
    "boxbox_store_pair_offset": ("boxbox.cu", "const size_t first = q0;",
                                 "const size_t first = q0 > 0 ? q0 - 1 : 0;", ("boxbox",)),
    # the world-vertex branch reads y and z of each vert swapped; the local
    # branch places the vert by its pose instead, so C and D stay sound
    "world_vert_yz_swapped": ("hull_sweep.cu", "return V3{l0, l1, l2};",
                              "return V3{l0, l2, l1};", ("hull_pair_world", "hull_manifold_world")),
    # the group argmin of the shared sweep (stage A, the rings) and of the
    # manifold's corner pick breaks ties to the higher index
    "manifold_argmin_ties_high": ("hull_sweep.cu", "(ov == v && oi < i)", "(ov == v && oi > i)",
                                  MANIFOLD + PAIR),
    # the shared sweep's stage A leaves out its last direction (the last
    # box normal at DX=6, the centre line at DX=0); on the table's box-mesh
    # pairs that normal (-z, into the table) never wins, so this fault
    # leaves their outputs as they are
    "manifold_stage_a_short": ("hull_sweep.cu", "const int nA = kDirs + 1 + a.DX;",
                               "const int nA = kDirs + a.DX;",
                               ("hull_manifold", "hull_manifold@table", "hull_manifold_world")
                               + PAIR),
    # the hull pair writes p1 as its contact point, not the witnesses'
    # midpoint
    "pair_pos_from_p1": ("hull_sweep.cu", MID, "const V3 mid = r.p1;", PAIR),
}

# faults run on kernels whose checks they are expected to pass, with the
# reason at the fault
PASSES = {"spd_rank1_skips_last_column": ("spd_inverse", "spd_inverse@dactyl"),
          "spd_diagonal_from_wrong_lane": ("spd_inverse@wide",), "spd_padding_zero": SPD,
          "spd_second_slot_skips_step": ("spd_inverse", "spd_inverse@hand", "spd_inverse@dactyl"),
          "spd_smem_diagonal_scaled": ("spd_inverse@dactyl",),
          "spd_dev_scratch_shared": ("spd_inverse@huge",), "dt_first_env": ("cg_full",),
          "weld_rotation_rows_dropped": ("cg_full",),
          # on the wide synthetic system the sound build and this one pass
          # alike: its late line-search choices stay inside float32's noise
          "tie_widened": ("cg_wide",)}


def build_variant(tmp: str, name: str, fault) -> None:
    """Load the kernel library built from a copy of the checkout's sources
    with `fault` planted."""
    from robogym_torch import cuda

    src = os.path.join(tmp, name)
    shutil.copytree(os.path.join(REPO, "robogym_torch", "csrc"), src)
    if fault is not None:
        path = os.path.join(src, fault[0])
        with open(path) as f:
            text = f.read()
        if text.count(fault[1]) != 1:
            raise RuntimeError(f"fault {name}: its text is not found once in {fault[0]}")
        with open(path, "w") as f:
            f.write(text.replace(fault[1], fault[2]))
    cuda.CSRC, cuda.BUILD_DIR, cuda._lib = src, os.path.join(tmp, "lib"), None
    cuda._size.cache_clear()
    cuda.build()


def capture(chip_smoke):
    """Each checked kernel's inputs at B=1024: {"spd_inverse": M,
    "spd_inverse@hand": M, "spd_inverse@dactyl": M of the dactyl-shaped
    world (V=36), "spd_inverse@dense36": dense seeded SPD matrices (V=36),
    "spd_inverse@wide": M of the wide system (V=96), "spd_inverse@huge"
    and "spd_inverse@dev": dense seeded SPD matrices (V=160, V=256),
    "cg_full" and "cg_full@dt": (args_of,
    iterations), "cg": (args_of, iterations), "cg_wide": (args_of,
    iterations), "boxbox": args, and (local operands, DX) for
    "hull_pair", "hull_pair_world", "hull_manifold", "hull_manifold_world",
    "hull_manifold@table-box" and "hull_manifold@table"}."""
    from robogym_torch.physics import cg_kernel, constraint_batched, factor_kernel, step
    from robogym_torch.physics.collision import boxbox_kernel, convex_kernel

    world = chip_smoke.worlds()
    state = {name: chip_smoke.start_states(m, arrays, chip_smoke.BATCH, chip_smoke.SEED, **kw)
             for name, (m, arrays, kw) in world.items()}
    ci, iterations, nfacet = chip_smoke.capture_core(world["locked_like"][0],
                                                     state["locked_like"])
    mh, dh = world["hand"][0], state["hand"]
    fa = chip_smoke.capture_call(cg_kernel, "cg", lambda: step.step(mh, dh))
    ms, ds = world["settle"][0], state["settle"]
    m, d = world["locked_like"][0], state["locked_like"]
    hull = {name + "_world": chip_smoke.capture_call(convex_kernel, name,
                                                    lambda: step.fwd_position(m, d))
            for name in ("hull_pair", "hull_manifold")}
    hull["hull_pair"], hull["hull_manifold"] = hull["hull_pair_world"], hull["hull_manifold_world"]
    mt, dt = world["table"][0], state["table"]
    hull["hull_manifold@table-box"], hull["hull_manifold@table"] = chip_smoke.capture_calls(
        convex_kernel, "hull_manifold", lambda: step.fwd_position(mt, dt))
    kind_s, its_w, nfacet_w, wargs = chip_smoke.wide_core_inputs(chip_smoke.BATCH)
    ci_w = constraint_batched.core_inputs(kind_s, nfacet_w,
                                          *[torch.as_tensor(a, device=m.device) for a in wargs])
    qs_w = torch.linalg.solve(ci_w["qM"], ci_w["qfrc_smooth"][..., None])[..., 0].contiguous()
    wide = (*cg_kernel.solve_inputs(ci_w["kind"], nfacet_w, ci_w["rows"], ci_w["maps"],
                                    ci_w["qvel"]),
            ci_w["qM"], factor_kernel.spd_inverse_plain(ci_w["qM"]), qs_w, ci_w["qacc_prev"])
    ci_d, _, _ = chip_smoke.capture_core(world["dactyl"][0], state["dactyl"])
    from robogym_torch.envs.dactyl import locked
    from robogym_torch import wrappers

    env = locked.make_env(device="cuda", seed=chip_smoke.SEED)
    wenv = wrappers.apply_dactyl_wrappers(env, randomize=True)
    ci_dt, its_dt, nfacet_dt = chip_smoke.capture_wrapped_core(
        wenv, wenv.reset(chip_smoke.BATCH)[0])
    renv, rstate, _, _ = chip_smoke.rearrange_env_reset(chip_smoke.BATCH)
    ci_rs, its_rs, nfacet_rs = chip_smoke.capture_rearrange(renv, rstate)["solver"]
    return {
        "spd_inverse": ci["qM"],
        "spd_inverse@dactyl": ci_d["qM"],
        "spd_inverse@dense36": chip_smoke.dense_spd(chip_smoke.BATCH, 36, m.device),
        "spd_inverse@wide": ci_w["qM"],
        "spd_inverse@huge": chip_smoke.dense_spd(chip_smoke.BATCH, chip_smoke.HUGE_V, m.device),
        "spd_inverse@dev": chip_smoke.dense_spd(chip_smoke.BATCH, chip_smoke.DEV_V, m.device),
        "spd_inverse@hand": chip_smoke.capture_call(factor_kernel, "spd_inverse",
                                                    lambda: step.step(mh, dh))[0],
        **{name: (args[:-1], args[-1]) for name, args in hull.items()},
        "cg_wide": (lambda its: (*wide, its), its_w),
        "cg_full": (lambda its: chip_smoke.cg_args(ci, its, nfacet), iterations),
        "cg_full@dt": (lambda its: chip_smoke.cg_args(ci_dt, its, nfacet_dt), its_dt),
        "cg_full@solver": (lambda its: chip_smoke.cg_args(ci_rs, its, nfacet_rs), its_rs),
        "cg": (lambda its: (*fa[:-1], its), fa[-1]),
        "boxbox": chip_smoke.capture_call(boxbox_kernel, "boxbox",
                                          lambda: step.fwd_position(ms, ds)),
    }


def readings(chip_smoke, kernel, inputs):
    """Print the check's readings for `kernel`; returns its failures."""
    from robogym_torch.physics.collision import boxbox_kernel

    if kernel.startswith("spd_inverse"):
        r, failures = chip_smoke.spd_readings(inputs)
        print(f"  {kernel}: rel err {r['max_err']:.3g} (tol {chip_smoke.SPD_TOL}); per-column err "
              f"vs float64 {r['column']:.3g}, plain version's {r['plain_column']:.3g} (at most "
              f"{chip_smoke.SPD_COLUMN_RATIO} x); bit-symmetric: {r['symmetric']}")
        return failures
    if kernel.startswith("hull_") and not kernel.endswith("_world"):
        loc_args, DX = inputs
        _, err, ties, total, failures = chip_smoke.hull_readings(kernel.split("@")[0], loc_args,
                                                                 DX)
        print(f"  {kernel}: max abs err where the directions agree {err:.3g}; pairs on another "
              f"direction {ties} of {total}")
        return failures
    if kernel.endswith("_world"):
        loc_args, DX = inputs
        _, err, ties, total, failures = chip_smoke.hull_readings(
            kernel, chip_smoke.to_world(loc_args), DX)
        diff, off = chip_smoke.world_vs_local(kernel[:-len("_world")], loc_args, DX)
        if off:
            failures.append(f"differs from the local kernel on {off} pair slots")
        print(f"  {kernel}: max abs err where the directions agree {err:.3g}; pairs on another "
              f"direction {ties} of {total}; against the local kernel: max abs diff {diff:.3g}, "
              f"{off} pair slots differ")
        return failures
    if kernel == "boxbox":
        got, want = boxbox_kernel.boxbox(*inputs), boxbox_kernel.boxbox_plain(*inputs)
        err, ties, total, failures = chip_smoke.boxbox_readings(inputs, got, want)
        sentinels = int(((got[0] >= 1e9) != (want[0] >= 1e9)).sum())
        print(f"  boxbox: max abs err where the axes agree {err:.3g}; pairs on another axis "
              f"{ties} of {total}; candidates differing in being sentinels {sentinels}")
        return failures
    args_of, iterations = inputs
    label, kernel = kernel, kernel.replace("cg_wide", "cg").split("@")[0]
    report = {}
    errs, early, noise, failures = chip_smoke.cg_readings(kernel, args_of, iterations, report)
    print(f"  {label}: envs excused on ties {len({e for e, _, _ in report['excused']})}"
          + "".join(f"; {chip_smoke.witness_text(*w)}" for w in report["excused"][:3]))
    print(f"  {label}: " + "; ".join(f"after {its}: " + ", ".join(
        f"{k} {v:.3g}" for k, v in e.items()) for its, e in early.items()))
    print(f"  {label}: after {iterations}, kernel vs plain (kernel vs float64, plain vs "
          "float64): " + ", ".join(f"{k} {errs[k]:.3g} ({noise[k][0]:.3g}, {noise[k][1]:.3g})"
                                   for k in errs))
    env_fails = any(f.startswith(("env ", "more envs")) or " more envs " in f for f in failures)
    early_fails = any(" iteration(s): rel err" in f for f in failures)
    step_fails = [f for f in failures if f.startswith("one-step")]
    step = report["one_step"]
    print(f"  {label}: one-step worst error / tolerance " + ", ".join(
        f"{f} {w:.3g} (step {k})" for f, (w, k) in step["worst"].items())
        + f"; envs excused on a pick tie at a step {len({e for e, _, _ in step['excused']})}")
    print(f"  {label}: envs leaving the forced plain version "
          f"{'FAIL' if env_fails else 'none'}, early check "
          f"{'FAILS' if early_fails else 'passes'}, one-step check "
          + (f"FAILS ({'; '.join(step_fails[:3])})" if step_fails else "passes")
          + "; " + chip_smoke.noise_verdict(noise))
    for its in (1, iterations):
        a = args_of(its)
        x_k = chip_smoke.wrapper(kernel)(*a)[0]
        x_p = chip_smoke.wrapper(kernel, plain=True)(*a)[0]
        off = (x_k - x_p).abs().amax(-1) > chip_smoke.CG_EARLY_TOL * x_p.abs().max()
        print(f"  {label}: after {its}: qacc off by more than {chip_smoke.CG_EARLY_TOL} rel in "
              f"{int(off.sum())} of {x_k.shape[0]} envs")
    return failures


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--faults", default="", help="comma-separated fault names (default: all)")
    names = [f for f in ap.parse_args().faults.split(",") if f]
    unknown = set(names) - set(FAULTS)
    if unknown:
        ap.error(f"unknown faults {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("cg_fault_check: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"[device] {chip_smoke.card_line()}", flush=True)
    bad = []
    with tempfile.TemporaryDirectory() as tmp:
        build_variant(tmp, "capture", None)
        inputs = capture(chip_smoke)
        for name, fault in FAULTS.items():
            if names and fault is not None and name not in names:
                continue
            build_variant(tmp, name, fault)
            kernels = CHECKED if fault is None else fault[3] + PASSES.get(name, ())
            for kernel in kernels:
                failures = readings(chip_smoke, kernel, inputs[kernel])
                print(f"[{name}] {kernel} check "
                      f"{'FAILS: ' + '; '.join(failures) if failures else 'passes'}", flush=True)
                if bool(failures) != (fault is not None and kernel not in PASSES.get(name, ())):
                    bad.append(f"{name}/{kernel}")
    print("cg_fault_check: " + (f"wrong verdict for {bad}" if bad else
                                "the sound kernels pass and every fault fails"))
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
