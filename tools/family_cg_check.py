"""Hold and time the kernels of the mesh-family envs' states, as
`chip_smoke.py` holds them, at two capture points; for the envs whose
paths `chip_smoke.py` does not drive (`FAMILY_WAITING`) the only measure.

    python3 tools/family_cg_check.py [--capture step|path] [ENV ...]

Runs on an NVIDIA GPU. For each env (by default those of
`chip_smoke.FAMILY_WAITING`) it builds the env with
`chip_smoke.FAMILY_CONFIGS`, resets it at B=1024 from seed 0 and checks the
reset state as `chip_smoke.family_readings` does. It then runs one env
step from the reset with every launch count set to 0 just before and read
just after (they must be the YCB env's: 160 A, 80 B, 121 C, 81 D), and
takes the kernels' inputs at the main sim's last substep of that step
(`--capture step`, `chip_smoke.capture_rearrange`, where `chip_smoke.py`
takes them) or of the path's `FAMILY_STEPS` steps (`--capture path`).
On them it runs `chip_smoke.phase_spd` (A), `phase_cg_full` (B: its early
check after 1 and 2 iterations and its 15-iteration noise check, timed
whether or not they pass) and `phase_hull` on the mesh-mesh group (C), and
prints whether B's checks pass, with E and V, and last one JSON line of
entries as `chip_smoke.py`'s kernels line. Envs whose B checks fail can be
examined with `tools/cg_near_tie.py --world ENV`.
"""

import argparse
import importlib
import json
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--capture", choices=("step", "path"), default="step")
    ap.add_argument("envs", nargs="*", default=None)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        print("family_cg_check: no CUDA device; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    import chip_smoke as cs
    from robogym_torch import cuda
    from robogym_torch.physics import cg_kernel, constraint_batched

    torch.backends.cuda.matmul.allow_tf32 = False
    cuda.build()
    print(f"[device] {cs.card_line()}", flush=True)
    entries = []
    for name in opts.envs or list(cs.FAMILY_WAITING):
        at = cs.FAMILY_AT[name]
        t0 = time.perf_counter()
        env = importlib.import_module("robogym_torch.envs.rearrange." + name).make_env(
            *cs.FAMILY_CONFIGS[name], device="cuda", seed=cs.SEED)
        torch.cuda.synchronize()
        draws = {}
        state, _ = cs.rearrange_reset(env, cs.BATCH, f"{name} env", time.perf_counter() - t0,
                                      draws)
        cs.family_readings(name, env, state, draws)
        torch.cuda.synchronize()
        cuda.reset_launches()
        cap = cs.capture_rearrange(env, state, ("hull_manifold",))
        torch.cuda.synchronize()
        launches = dict(cuda.LAUNCHES)
        want = cs.PER_CALL["ycb_env"]
        print(f"[{name}] one env step at B={cs.BATCH}: launches {launches} (want {want})")
        cs.check({k: v for k, v in launches.items() if v} == want, f"{name}: launches")
        ci, its, nfacet = cap["main"]
        *hargs, hDX = cap["hull_manifold"]
        if opts.capture == "path":
            last = {}
            with cs.patched([((constraint_batched, "fused_step_core"),
                              lambda *a, fn=constraint_batched.fused_step_core:
                              last.update(args=a) or fn(*a))]):
                cs.family_path(name, env, state, {}, [])
            kind_s, its, nfacet, *args = last["args"]
            ci = constraint_batched.core_inputs(kind_s, nfacet, *args)
        E, V = len(ci["kind"]), ci["qM"].shape[-1]
        res = {"spd_inverse@" + at: cs.phase_spd("A spd_inverse@" + at, ci["qM"], cs.REPS)}
        if cg_kernel.fits(E, V, True):
            r = res["cg_full@" + at] = cs.phase_cg_full(f"B cg_full@{at}", ci, its, nfacet,
                                                        cs.REPS, hold=False)
            print(f"[{name}] capture {opts.capture}: E={E}, V={V}: B's checks "
                  + ("pass" if not r["failures"] else "fail: " + "; ".join(r["failures"])))
        else:
            print(f"[{name}] E={E}, V={V}: above kernel B's shared memory, not checked here")
        res["hull_manifold@" + at] = cs.phase_hull("hull_manifold", hargs, hDX, cs.REPS,
                                                   "C hull_manifold@" + at)
        for entry, r in res.items():
            k = entry.partition("@")[0]
            entries.append(dict(name=entry, capture=opts.capture, E=E, V=V,
                                launches_per_env_step=launches.get(k, 0),
                                checks_pass=not r.get("failures"),
                                max_abs_err=r["max_abs_err"], ms=r["ms"],
                                plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                                bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": entries}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
