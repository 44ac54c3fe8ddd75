#!/usr/bin/env python3
"""Drive the PyTorch port's physics step on one NVIDIA GPU and hold every
hand-written kernel against its plain PyTorch version.

    python3 chip_smoke.py [--profile PATH]

Phases, in order; any failure ends the script with a non-zero exit:

1. Device: needs CUDA; prints the card's name and power limit.
2. Build: compiles the CUDA kernels from `robogym_torch/csrc/` and prints
   what `nvcc -Xptxas -v` reports per kernel.
3. State: the locked-like world (`robogym_torch/worlds/locked_like.npz`),
   B=1024 start states from seed 0, settled for 20 substeps so contacts are
   live.
4. One phase per kernel: its inputs are captured from one substep of the
   main path; the kernel and its plain version run on the same inputs on
   the card, and are compared and timed (CUDA events over 50 launches,
   after a warm-up), with a library call beside them where one computes
   the same function.
5. Main path: `step_n` for 20 env steps of 10 substeps; every qpos and qvel
   finite; every kernel's launch count grew by its count per substep;
   env-steps/s on the host clock.
6. Whole-step agreement: one substep through the kernels against one
   through the plain versions, at B=64.
7. Summary: a `kernels` line and a `main_path` line of JSON, the card's
   name and power limit, and last `{"ok": true, "device": {...}}`.

`--profile PATH` also writes a device-time breakdown of three substeps,
with their wall time and the device's busy share, to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
BATCH = 1024                      # envs of the main path
ENV_STEPS = 20                    # env steps the main path runs
SUBSTEPS = 10                     # substeps per env step (envs/core.py)
SEED = 0
REPS = 50                         # launches per kernel timing
HBM_BYTES_PER_S = 3.35e12         # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12           # H100 SXM data sheet, float32 outside the tensor cores
CG_EARLY_TOL = 1e-4               # kernel B vs plain after 1 and 2 iterations, relative
NOISE_RATIO = 2                   # kernel B's float32 error vs the plain version's, both vs float64
NEAR_TIE_TOL = 5e-3               # witness check of a hull pair on a bf16 near-tie (m)
PER_SUBSTEP = {"spd_inverse": 2, "cg_full": 1, "hull_manifold": 1, "hull_pair": 1}
TPU_KERNELS = {
    "spd_inverse": "robogym_tpu/physics/factor_kernel.py:37 _spd_inverse_kernel",
    "cg_full": "robogym_tpu/physics/cg_kernel.py:320 _cg_full_kernel",
    "hull_manifold": "robogym_tpu/physics/collision/convex_kernel.py:240 _manifold_kernel_loc",
    "hull_pair": "robogym_tpu/physics/collision/convex_kernel.py:215 _hull_kernel_loc",
}
SOURCES = {
    "spd_inverse": "robogym_torch/csrc/spd_inverse.cu",
    "cg_full": "robogym_torch/csrc/cg_full.cu",
    "hull_manifold": "robogym_torch/csrc/hull_sweep.cu",
    "hull_pair": "robogym_torch/csrc/hull_sweep.cu",
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` calls after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes: float, flops: float):
    t_b, t_f = n_bytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


@contextlib.contextmanager
def capture_hull_inputs(store):
    """Record the hull kernels' arguments as the collision driver passes them."""
    from robogym_torch.physics.collision import convex_kernel

    orig = {n: getattr(convex_kernel, n) for n in ("hull_pair", "hull_manifold")}

    def recorder(name):
        def fn(*args):
            store[name] = (tuple(a.clone() for a in args[:-1]), args[-1])
            return orig[name](*args)
        return fn

    try:
        for n in orig:
            setattr(convex_kernel, n, recorder(n))
        yield
    finally:
        for n, f in orig.items():
            setattr(convex_kernel, n, f)


@contextlib.contextmanager
def plain_versions():
    """Route one substep through the kernels' plain versions, by name."""
    from robogym_torch.physics import constraint_batched
    from robogym_torch.physics.collision import convex_kernel

    saved = [(convex_kernel, "hull_pair", convex_kernel.hull_pair_plain),
             (convex_kernel, "hull_manifold", convex_kernel.hull_manifold_plain),
             (constraint_batched, "fused_step_core", constraint_batched.reference)]
    orig = [(mod, name, getattr(mod, name)) for mod, name, _ in saved]
    try:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
        yield
    finally:
        for mod, name, fn in orig:
            setattr(mod, name, fn)


def cg_flops(E: int, V: int, S: int, F: int, iterations: int) -> float:
    """Operations of the fused solve: building J (each contact's relative
    Jacobian once, 33 per dof, and its 3 frame projections, 15 per dof,
    then 2 per facet entry), aref and the warmstart, per CG iteration J p,
    J^T f, three (V, V) matvecs, about 100 per row of forces, costs and
    line search, and the final J^T f and four (V, V) matvecs of the Euler
    update."""
    build = S * V * (33 + 15) + 2 * S * F * V
    setup = 4 * E * V + 2 * E * V + 6 * V * V + 20 * E
    per_it = 4 * E * V + 6 * V * V + 100 * E + 20 * V
    final = 2 * E * V + 8 * V * V
    return build + setup + iterations * per_it + final


def hull_flops(K: int, V1: int, V2: int, ndir: int, manifold: bool) -> float:
    """Per pair: the world transform and centering (21 a vert), 5 per vert
    and side for each direction's bf16 dot, the witness extraction (10 a
    vert), and for the manifold 4 support bounds on side 2 and 26 per
    side-1 corner."""
    per = (V1 + V2) * (21 + 5 * ndir + 10)
    if manifold:
        per += 4 * 5 * V2 + 26 * V1
    return K * per


def phase_spd(ci, reps):
    from robogym_torch.physics import factor_kernel as fk

    A = ci["qM"]
    got, want = fk.spd_inverse(A), fk.spd_inverse_plain(A)
    torch.cuda.synchronize()
    err = rel_err(got, want)
    check(bool(torch.isfinite(got).all()), "spd_inverse: non-finite output")
    check(err <= 1e-5, f"spd_inverse: rel err {err:.3g} > 1e-5")
    B, V, _ = A.shape
    ms = timed_ms(lambda: fk.spd_inverse(A), reps)
    plain_ms = timed_ms(lambda: fk.spd_inverse_plain(A), reps)
    lib_ms = timed_ms(lambda: torch.linalg.inv(A), reps)
    chol_ms = timed_ms(lambda: torch.cholesky_inverse(torch.linalg.cholesky(A)), reps)
    b_ms, b_by = bound(2 * nbytes(A), B * V ** 3)
    print(f"[A spd_inverse] B={B} V={V} rel err {err:.3g} (tol 1e-5, ref |max| "
          f"{float(want.abs().max()):.4g}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"linalg.inv {lib_ms:.4f} ms, cholesky_inverse {chol_ms:.4f} ms, bound {b_ms:.5f} ms")
    return dict(max_abs_err=float((got - want).abs().max()), max_err=err, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, cholesky_inverse_ms=chol_ms,
                bound_ms=b_ms, bound_by=b_by, tol=1e-5)


def to_float64(x):
    if isinstance(x, torch.Tensor):
        return x.double()
    if isinstance(x, dict):
        return {k: to_float64(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(to_float64(v) for v in x)
    return x


CG_OUTPUTS = ("qacc", "efc_force", "qfrc", "qvel_new", "qacc_smooth")


def cg_args(ci, iterations, nfacet):
    """Kernel B's arguments from the fused core's captured inputs, with the
    plain SPD inverses."""
    from robogym_torch.physics import factor_kernel as fk

    Minv, Minv_imp = fk.spd_inverse_plain(ci["qM"]), fk.spd_inverse_plain(ci["Mimp"])
    return (ci["kind"], iterations, nfacet, ci["rows"], ci["maps"], ci["qM"], Minv, ci["Mimp"],
            Minv_imp, ci["qvel"], ci["qfrc_smooth"], ci["qacc_prev"], ci["dt"])


def cg_readings(ci, iterations, nfacet):
    """Kernel B against its plain version on the same inputs. Returns
    (errs, early, noise, failures): the full solve's relative errors
    kernel vs plain; the same after 1 and 2 iterations; and per output
    (kernel vs float64, plain vs float64), the float64 run being the plain
    version's.

    The kernel sums in another order than the plain version, and 15
    unconverged CG iterations with a discrete line search carry float32's
    last-bit noise far into the result (at B=1024 the plain version's qfrc
    differs from a float64 run of it by 5e-2). So the full solve is held to
    float32's own noise, its error against the float64 run at most
    NOISE_RATIO times the plain version's, and the first two iterations,
    before the noise has grown, to CG_EARLY_TOL."""
    from robogym_torch.physics import cg_kernel

    failures, early = [], {}
    for its in (1, 2):
        a = cg_args(ci, its, nfacet)
        got, want = cg_kernel.cg_full(*a), cg_kernel.cg_full_plain(*a)
        early[its] = {n: rel_err(g, w) for n, g, w in zip(CG_OUTPUTS, got, want)}
        failures += [f"{n} after {its} iteration(s): rel err {e:.3g} > {CG_EARLY_TOL}"
                     for n, e in early[its].items() if not e <= CG_EARLY_TOL]
    a = cg_args(ci, iterations, nfacet)
    got, want = cg_kernel.cg_full(*a), cg_kernel.cg_full_plain(*a)
    exact = cg_kernel.cg_full_plain(*to_float64(a))
    errs, noise = {}, {}
    for name, g, w, x in zip(CG_OUTPUTS, got, want, exact):
        if not bool(torch.isfinite(g).all()):
            failures.append(f"non-finite {name}")
        errs[name] = rel_err(g, w)
        e_k, e_p = noise[name] = (rel_err(g.double(), x), rel_err(w.double(), x))
        if not e_k <= NOISE_RATIO * e_p + 1e-6:
            failures.append(f"{name} err vs float64 {e_k:.3g} > {NOISE_RATIO} x plain's {e_p:.3g}")
    torch.cuda.synchronize()
    return errs, early, noise, failures


def phase_cg(ci, iterations, nfacet, reps):
    from robogym_torch import cuda
    from robogym_torch.physics import cg_kernel

    errs, early, noise, failures = cg_readings(ci, iterations, nfacet)
    for its, e in early.items():
        print(f"[B cg_full] after {its} iteration(s), rel err kernel vs plain (tol "
              f"{CG_EARLY_TOL}): " + ", ".join(f"{k} {v:.3g}" for k, v in e.items()))
    print(f"[B cg_full] after {iterations}, rel err kernel vs plain (kernel vs float64, plain vs "
          "float64): " + ", ".join(f"{k} {errs[k]:.3g} ({noise[k][0]:.3g}, {noise[k][1]:.3g})"
                                   for k in CG_OUTPUTS))
    check(not failures, "cg_full: " + "; ".join(failures))
    args = cg_args(ci, iterations, nfacet)
    got, want = cg_kernel.cg_full(*args), cg_kernel.cg_full_plain(*args)
    ms = timed_ms(lambda: cg_kernel.cg_full(*args), reps)
    plain_ms = timed_ms(lambda: cg_kernel.cg_full_plain(*args), max(2, reps // 10))
    rows = ci["rows"]
    B, n_s, V = rows["Js"].shape
    S = rows["off1"].shape[1]
    E = n_s + S * nfacet
    ins = list(rows.values()) + list(ci["maps"].values()) + list(args[5:12])
    n_b = nbytes(*ins) + 4 * E + 4 + nbytes(*got)
    b_ms, b_by = bound(n_b, B * cg_flops(E, V, S, nfacet, iterations))
    print(f"[B cg_full] B={B} E={E} V={V} S={S} F={nfacet}: "
          + f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}), "
          f"smem/block {cuda.cg_full_smem_bytes(E, V)} B")
    return dict(max_abs_err=max(float((g - w).abs().max()) for g, w in zip(got, want)),
                max_err=max(errs.values()), errs=errs, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by)


def check_near_ties(name, args, got, n_plain, tied):
    """Where the kernel chose another direction than the plain version, the
    plain version's selection score (bf16 dots) along the kernel's direction
    must equal the score along its own to within one bf16 ulp of the dots;
    for a hull pair the kernel's witness points must also be supports of
    both hulls along its normal, to NEAR_TIE_TOL."""
    from robogym_torch.physics.collision import convex_kernel as ck

    v1, v2 = ck.world_from_loc(*args[0:3]), ck.world_from_loc(*args[3:6])
    c1, c2 = args[6], args[7]
    s_k, _ = ck.selection_score(v1, v2, c1, c2, got[2])
    s_p, scale = ck.selection_score(v1, v2, c1, c2, n_plain)
    gap = (s_k - s_p).abs()[tied]
    ulp = (torch.finfo(torch.bfloat16).eps * scale)[tied]
    check(bool((gap <= ulp).all()),
          f"{name}: a near-tie's selection scores differ by {float((gap - ulp).max()):.3g} "
          "more than one bf16 ulp")
    if name == "hull_pair":
        dist, pos, n, p2 = (x[tied] for x in got)
        p1 = 2.0 * pos - p2
        d1 = torch.einsum("pi,piv->pv", n, v1[tied]).amax(-1)
        d2 = torch.einsum("pi,piv->pv", n, v2[tied]).amin(-1)
        ok = ((-(d1 - d2) - dist).abs() <= NEAR_TIE_TOL) \
            & ((n * p1).sum(-1) >= d1 - NEAR_TIE_TOL) & ((n * p2).sum(-1) <= d2 + NEAR_TIE_TOL)
        check(bool(ok.all()), f"{name}: {int((~ok).sum())} near-tie witnesses are not supports")


def phase_hull(name, args, DX, reps):
    from robogym_torch.physics.collision import convex_kernel as ck

    kern, plain = getattr(ck, name), getattr(ck, name + "_plain")
    got, want = kern(*args, DX), plain(*args, DX)
    torch.cuda.synchronize()
    n_g, n_w = got[2], want[2]
    same = (n_g - n_w).abs().amax(-1) <= 1e-6                         # (B, K)
    ties = int((~same).sum())
    total = same.numel()
    # dist/pos/normal to 1e-5 where both picked the same direction; a
    # near-tie of the bf16 selection may pick another (at most 1 in 100)
    check(ties <= total // 100, f"{name}: {ties} of {total} pairs chose another direction")
    if ties:
        check_near_ties(name, args, got, n_w, ~same)
    errs = []
    for g, w in zip(got, want):
        g, w = g[same], w[same]
        live = w.abs() < 1e9
        check(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
        errs.append(float((g - w).abs()[live].max()) if bool(live.any()) else 0.0)
    err = max(errs)
    check(err <= 1e-5, f"{name}: max abs err {err:.3g} > 1e-5")
    ms = timed_ms(lambda: kern(*args, DX), reps)
    plain_ms = timed_ms(lambda: plain(*args, DX), max(2, reps // 10))
    B, K, _, V1 = args[0].shape
    V2 = args[3].shape[-1]
    ndir = 12 + 1 + DX + 16
    n_b = nbytes(*args[:8]) + nbytes(args[8][:, :, :max(DX, 1)]) + nbytes(*got)
    b_ms, b_by = bound(n_b, B * hull_flops(K, V1, V2, ndir, name == "hull_manifold"))
    print(f"[{'C' if name == 'hull_manifold' else 'D'} {name}] B={B} K={K} V1={V1} V2={V2} "
          f"DX={DX} max abs err {err:.3g} (tol 1e-5), near-ties {ties}/{total}; kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by})")
    return dict(max_abs_err=err, max_err=err, ties=ties, pairs=total, ms=ms, plain_ms=plain_ms,
                library_ms=None, bound_ms=b_ms, bound_by=b_by, tol=1e-5)


def load_world():
    """The locked-like world's Model on the card, and its snapshot arrays."""
    from robogym_torch import bridge
    from robogym_torch.worlds import locked_like

    with np.load(locked_like.SNAPSHOT) as z:
        arrays = {k: z[k] for k in z.files}
    return bridge.model_from_numpy(arrays, "cuda"), arrays


def capture_inputs(m, d):
    """Every kernel's inputs as one substep of the main path from state d
    gives them: (the fused core's inputs, CG iterations, facets per
    contact, {"hull_pair": (args, DX), "hull_manifold": (args, DX)})."""
    from robogym_torch.physics import constraint, constraint_batched, step

    hull_args = {}
    with capture_hull_inputs(hull_args):
        d1, qfrc_smooth = step.forward_smooth(m, d)
    kind_s, iterations, nfacet, args, _, _ = constraint.fused_core_inputs(m, d1, qfrc_smooth)
    check(set(hull_args) == {"hull_pair", "hull_manifold"}, f"hull kernels seen: {set(hull_args)}")
    return constraint_batched.core_inputs(kind_s, nfacet, *args), iterations, nfacet, hull_args


def start_states(m, arrays, batch, seed, settle):
    from robogym_torch.mjcf.model import make_data
    from robogym_torch.physics import step
    from robogym_torch.worlds import locked_like

    qpos, ctrl = locked_like.initial_state(arrays, batch, seed)
    d = make_data(m, batch, torch.as_tensor(qpos, device=m.device))
    d = d.replace(ctrl=torch.as_tensor(ctrl, device=m.device))
    return step.step_n(m, d, settle)


def profile_substeps(m, d, path):
    """torch.profiler over 3 substeps: kernel time by name, launches, and
    the device's busy share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    from robogym_torch.physics import step

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            d = step.step(m, d)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    n_kernels = sum(e.count for e in kernels)
    head = (f"3 substeps at B={d.qpos.shape[0]} under the profiler: wall {wall_ms:.3f} ms, "
            f"device busy {busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f} %), "
            f"{n_kernels} kernel launches")
    table = events.table(sort_by="self_cuda_time_total", row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write(head + "\n" + table + "\n")
    print("[profile] " + head)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH", help="write a profile of 3 substeps here")
    opts = ap.parse_args()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from robogym_torch import cuda
    from robogym_torch.physics import step

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {card} (torch {torch.__version__}, CUDA {torch.version.cuda})", flush=True)

    # 2. build
    t0 = time.perf_counter()
    log = cuda.build()
    print(f"[build] nvcc sm_90a, {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas info" in line and ("Used" in line or "Compiling entry" in line) or "spill" in line:
            print("  " + line.strip())

    # 3. state
    m, arrays = load_world()
    B = BATCH
    t0 = time.perf_counter()
    d = start_states(m, arrays, B, SEED, settle=20)
    torch.cuda.synchronize()
    live = d.contact.active.sum(1)
    print(f"[state] B={B} settled 20 substeps in {time.perf_counter() - t0:.2f} s; live contacts "
          f"per env: mean {float(live.float().mean()):.2f}, envs with none "
          f"{int((live == 0).sum())}")
    check(bool(live.sum() > 0), "no live contact after settling")

    # 4. one phase per kernel, on inputs captured from one substep
    ci, iterations, nfacet, hull_args = capture_inputs(m, d)
    res = {"spd_inverse": phase_spd(ci, REPS),
           "cg_full": phase_cg(ci, iterations, nfacet, REPS)}
    for name in ("hull_manifold", "hull_pair"):
        res[name] = phase_hull(name, *hull_args[name], REPS)

    # 5. main path
    dm = d
    torch.cuda.synchronize()
    cuda.reset_launches()
    t0 = time.perf_counter()
    for _ in range(ENV_STEPS):
        dm = step.step_n(m, dm, SUBSTEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cuda.LAUNCHES)
    n_sub = ENV_STEPS * SUBSTEPS
    check(bool(torch.isfinite(dm.qpos).all() and torch.isfinite(dm.qvel).all()),
          "main path: non-finite qpos/qvel")
    for name, per in PER_SUBSTEP.items():
        check(launches[name] == per * n_sub,
              f"main path: {name} launched {launches[name]} times, want {per * n_sub}")
    sps = B * ENV_STEPS / wall
    print(f"[main path] {ENV_STEPS} env steps x {SUBSTEPS} substeps at B={B}: {wall:.3f} s, "
          f"{sps:.1f} env-steps/s; launches {launches}; live contacts per env "
          f"{float(dm.contact.active.sum(1).float().mean()):.2f}")

    # 6. whole-step agreement at B=64: one substep through the kernels
    # against one through the plain versions; qpos to 1e-4 abs, qvel to
    # 1e-3 of its largest value (the CG's float32 noise, phase B)
    ds = start_states(m, arrays, 64, SEED + 1, settle=20)
    got = step.step(m, ds)
    with plain_versions():
        want = step.step(m, ds)
    torch.cuda.synchronize()
    for k in ("qpos", "qvel"):
        g, w = getattr(got, k), getattr(want, k)
        e = float((g - w).abs().max())
        tol = 1e-4 if k == "qpos" else 1e-3 * float(w.abs().max())
        print(f"[whole step] B=64 one substep, kernels vs plain versions: {k} max abs err "
              f"{e:.3g} (tol {tol:.3g})")
        check(bool(torch.isfinite(g).all()) and e <= tol,
              f"whole step: {k} differs by {e:.3g} > {tol:.3g}")

    if opts.profile:
        profile_substeps(m, dm, opts.profile)

    # 7. summary
    kernels = []
    for name in ("cg_full", "spd_inverse", "hull_manifold", "hull_pair"):
        r = res[name]
        kernels.append(dict(
            name=name, route="cuda", source=SOURCES[name], replaces=TPU_KERNELS[name],
            launches=launches[name], max_abs_err=r["max_abs_err"], max_err=r["max_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"main_path": dict(env_steps_per_s=sps, batch=B, env_steps=ENV_STEPS,
                                        substeps=SUBSTEPS, seconds=wall, card=card)}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
