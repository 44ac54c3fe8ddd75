"""Kernel B's CUDA source (`robogym_torch/csrc/cg_full.cu`) run on the CPU
and held against its plain version.

The source is compiled by the host's C++ compiler against a stand-in for
the CUDA runtime (`tests/host_cuda/cuda_runtime.h`): each block runs as 32
threads, which meet at a barrier for every shuffle, vote and __syncwarp, so
the kernel's own indexing, shared-memory layout and reductions run as
written, in IEEE single precision without contracted multiply-adds (as
nvcc -fmad=false builds it). The inputs are those of one substep of the
locked-like world (E=152, V=30) and of the goal-settle world (E=192, no
scalar row), and the synthetic system of test_torch_kernels.py (V=40, two
dofs a lane; E=328, rows past the register rows), at B=2: 1e-4 relative
after 1 and 2 CG iterations (chip_smoke.py's CG_EARLY_TOL), and after 15
the tolerances that hold the plain version to the JAX package
(test_torch_kernels.py: qfrc 1e-2, where 15 unconverged iterations keep
the last-bit noise of another summation order, the rest 1e-4). With a
per-env timestep (seeded in [1.5, 2.5] ms, the kernel reading dt with a
stride of 1) the same tolerances hold, and one timestep given as a (B,)
tensor of equal values gives the outputs of the same timestep given once
(stride 0), bit for bit."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_common import core_inputs, locked_like_model, locked_like_state, settle_state
from robogym_torch.physics import cg_kernel, constraint_batched, factor_kernel
from test_torch_kernels import _wide_core_inputs

import chip_smoke

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "robogym_torch", "csrc")
B = 2
OUTPUTS = ("qacc", "efc_force", "qfrc", "qvel_new", "qacc_smooth")
TOLS = dict(qacc=1e-4, efc_force=1e-4, qfrc=1e-2, qvel_new=1e-4, qacc_smooth=1e-4)


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The runner of kernel B built for the host; skips without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to run the CUDA source on the host")
    out = tmp_path_factory.mktemp("host_cuda")
    with open(os.path.join(CSRC, "cg_full.cu")) as f:
        src = f.read()
    src = re.sub(r"<<<[^>]*>>>", "", src).replace("  extern __shared__ float sm[];\n", "")
    (out / "cg_full_host.cpp").write_text(src)
    exe = out / "run_cg_full"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off",
                    "-Wno-unknown-pragmas", f"-I{out}", f"-I{os.path.join(HERE, 'host_cuda')}",
                    f"-I{CSRC}", "-o", str(exe), os.path.join(HERE, "host_cuda", "run_cg_full.cpp")],
                   check=True, capture_output=True, text=True)
    return str(exe), out


def _run(host_kernel, args, euler, trace=False):
    """Kernel B on the host on `chip_smoke.cg_args`-style arguments (with
    the Euler update) or `cg_full_noeuler`'s (without): its outputs, and
    with `trace` its trace (`cg_kernel.split_trace`) after them."""
    exe, tmp = host_kernel
    if euler:
        kind, its, nfacet, rows, maps, M, Minv, Mimp, Minv_imp, qvel, qfs, qprev, dt = args
        tail = [Mimp, Minv_imp, qvel, qfs, qprev, None, None, torch.as_tensor(dt).reshape(-1)]
    else:
        kind, its, nfacet, rows, maps, M, Minv, qvel, qs, x0 = args
        tail = [None, None, qvel, None, None, qs, x0, None]
    Bn, n_s, V = rows["Js"].shape
    S = rows["off1"].shape[1]
    E = n_s + S * nfacet
    arrs = [rows[k] for k in ("Js", "off1", "off2", "frame", "fric", "m1", "m2", "cdof")]
    arrs += [maps[k] for k in ("pos", "kimp", "bref", "rcoef", "active", "floss")] + [M, Minv]
    fin, fout = str(tmp / "in.bin"), str(tmp / "out.bin")
    with open(fin, "wb") as f:
        np.array([Bn, n_s, S, nfacet, V, its, int(euler), int(trace)], np.int32).tofile(f)
        for a in arrs + tail:
            a = np.zeros(0, np.float32) if a is None else a.numpy().astype(np.float32).ravel()
            np.array([a.size], np.int64).tofile(f)
            a.tofile(f)
        k = np.asarray(kind, np.int32)
        np.array([k.size], np.int64).tofile(f)
        k.tofile(f)
    subprocess.run([exe, fin, fout], check=True)
    o = np.fromfile(fout, np.float32)
    sizes = [Bn * V, Bn * E, Bn * V, Bn * V, Bn * V]
    x, f, qfrc, qvel_new, qs_out, tr = (torch.as_tensor(p)
                                        for p in np.split(o, np.cumsum(sizes)))
    got = (x.reshape(Bn, V), f.reshape(Bn, E), qfrc.reshape(Bn, V))
    got += (qvel_new.reshape(Bn, V), qs_out.reshape(Bn, V)) if euler else ()
    if trace:
        got += (cg_kernel.split_trace(tr.reshape(Bn, its + 1, 4 * V + E + 2), V, E),)
    return got


def _case(name):
    """(core_inputs dict, iterations, nfacet) of a case, B envs."""
    if name == "locked_like":
        tm = locked_like_model()
        kind_s, its, nfacet, args = core_inputs(tm, locked_like_state(tm, B, seed=0))
    elif name == "settle":
        kind_s, its, nfacet, args = core_inputs(*settle_state(B))
    else:
        kind_s, its, nfacet, args = _wide_core_inputs(batch=B)
        args = [torch.as_tensor(a) for a in args]
    return constraint_batched.core_inputs(kind_s, nfacet, *args), its, nfacet


@pytest.mark.parametrize("euler", [True, False], ids=["euler", "noeuler"])
@pytest.mark.parametrize("case", ["locked_like", "settle", "wide"])
def test_cg_full_source_on_host_matches_plain(host_kernel, case, euler):
    ci, its, nfacet = _case(case)
    Minv = factor_kernel.spd_inverse_plain(ci["qM"])
    qs = torch.linalg.solve(ci["qM"], ci["qfrc_smooth"][..., None])[..., 0]

    def args_of(k):
        if euler:
            return chip_smoke.cg_args(ci, k, nfacet)
        return (ci["kind"], k, nfacet, ci["rows"], ci["maps"], ci["qM"], Minv, ci["qvel"], qs,
                ci["qacc_prev"])

    plain = cg_kernel.cg_full_plain if euler else cg_kernel.cg_full_noeuler_plain
    for k in (1, 2):
        for name, g, w in zip(OUTPUTS, _run(host_kernel, args_of(k), euler), plain(*args_of(k))):
            assert chip_smoke.rel_err(g, w) <= chip_smoke.CG_EARLY_TOL, (name, k)
    got, want = _run(host_kernel, args_of(its), euler), plain(*args_of(its))
    for name, g, w in zip(OUTPUTS, got, want):
        assert bool(torch.isfinite(g).all()), name
        assert chip_smoke.rel_err(g, w) <= TOLS[name], (name, chip_smoke.rel_err(g, w))
    assert bool((got[1] != 0).any()), "no live row"


def _per_env_dt(ci, nfacet, its, dt):
    """`chip_smoke.cg_args` with the timestep `dt` in place of the captured
    one."""
    return chip_smoke.cg_args(dict(ci, dt=dt), its, nfacet)


def test_cg_full_source_on_host_per_env_dt_matches_plain(host_kernel):
    ci, its, nfacet = _case("locked_like")
    dt = torch.as_tensor(np.random.default_rng(3).uniform(1.5e-3, 2.5e-3, B).astype(np.float32))
    args = _per_env_dt(ci, nfacet, its, dt)
    got, want = _run(host_kernel, args, True), cg_kernel.cg_full_plain(*args)
    for name, g, w in zip(OUTPUTS, got, want):
        assert bool(torch.isfinite(g).all()), name
        assert chip_smoke.rel_err(g, w) <= TOLS[name], (name, chip_smoke.rel_err(g, w))
    # each env's velocity update takes its own timestep
    one = [_run(host_kernel, _per_env_dt(ci, nfacet, its, dt[i]), True)[3][i] for i in range(B)]
    assert torch.equal(got[3], torch.stack(one))


def test_cg_full_source_on_host_dt_stride_zero_equals_stride_one(host_kernel):
    ci, its, nfacet = _case("locked_like")
    dt = torch.as_tensor(ci["dt"], dtype=torch.float32)
    shared = _run(host_kernel, _per_env_dt(ci, nfacet, its, dt.reshape(())), True)
    per_env = _run(host_kernel, _per_env_dt(ci, nfacet, its, dt.reshape(()).expand(B)), True)
    for name, a, b in zip(OUTPUTS, shared, per_env):
        assert torch.equal(a, b), name
