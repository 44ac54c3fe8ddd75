"""Kernel F's CUDA source (`robogym_torch/csrc/cg.cu`) run on the CPU and
held against its plain version, as tests/test_torch_cg_full_host.py holds
kernel B: compiled by the host's C++ compiler against the stand-in CUDA
runtime of `tests/host_cuda/`, each block as 32 threads that meet at a
barrier for every shuffle and __syncwarp, in IEEE single precision without
contracted multiply-adds.

Both instantiations run at B=2, chosen by hand rather than by size: J in
shared memory and J in device memory (the route of systems too large for
shared memory), on the inputs of one hand-world substep (E = V = 24), where
the two must agree bit for bit (they sum in the same order), and the device
route on chip_smoke.py's wide system (V=96, E=408: `cg_kernel.solve_inputs`
of `chip_smoke.wide_core_inputs`), which exceeds kernel B's shared memory.
Tolerances: 1e-4 relative after 1 and 2 CG iterations (chip_smoke.py's
CG_EARLY_TOL); after 15, those that hold `cg_plain` to the JAX package
(test_torch_kernels.py::test_cg_plain_matches_jax: x to 2e-3 relative +
5e-4, f to 5e-3)."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_common import hand_state
from robogym_torch.physics import cg_kernel, constraint_batched, factor_kernel
from robogym_torch.physics import step as t_step

import chip_smoke

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "robogym_torch", "csrc")
B = 2
SHARED, DEVICE = 0, 1


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The runner of kernel F built for the host; skips without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to run the CUDA source on the host")
    out = tmp_path_factory.mktemp("host_cuda")
    with open(os.path.join(CSRC, "cg.cu")) as f:
        src = f.read()
    src = re.sub(r"<<<[^>]*>>>", "", src).replace("  extern __shared__ float sm[];\n", "")
    (out / "cg_host.cpp").write_text(src)
    exe = out / "run_cg"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off",
                    "-Wno-unknown-pragmas", f"-I{out}", f"-I{os.path.join(HERE, 'host_cuda')}",
                    f"-I{CSRC}", "-o", str(exe), os.path.join(HERE, "host_cuda", "run_cg.cpp")],
                   check=True, capture_output=True, text=True)
    return str(exe), out


def _run(host_kernel, args, route, trace=False):
    """Kernel F on the host on `cg`'s arguments, J in shared memory
    (SHARED) or device memory (DEVICE): (x, f), and with `trace` its trace
    (`cg_kernel.split_trace`)."""
    exe, tmp = host_kernel
    *arrs, its = args
    Bn, E, V = arrs[0].shape
    fin, fout = str(tmp / "in.bin"), str(tmp / "out.bin")
    with open(fin, "wb") as f:
        np.array([Bn, E, V, its, route, int(trace)], np.int32).tofile(f)
        for a in arrs:
            a = a.numpy().astype(np.float32).ravel()
            np.array([a.size], np.int64).tofile(f)
            a.tofile(f)
    subprocess.run([exe, fin, fout], check=True)
    x, f, tr = np.split(np.fromfile(fout, np.float32), [Bn * V, Bn * V + Bn * E])
    out = torch.as_tensor(x).reshape(Bn, V), torch.as_tensor(f).reshape(Bn, E)
    if not trace:
        return out
    buf = torch.as_tensor(tr).reshape(Bn, its + 1, 4 * V + E + 2)
    return (*out, cg_kernel.split_trace(buf, V, E))


@pytest.fixture(scope="module")
def hand_args():
    """`cg`'s arguments (iterations last) from one hand-world substep."""
    tm, d = hand_state(B)
    return chip_smoke.capture_call(cg_kernel, "cg", lambda: t_step.step(tm, d))


def _wide_args():
    """`cg`'s arguments for chip_smoke.py's wide system at B envs."""
    kind_s, its, nfacet, args = chip_smoke.wide_core_inputs(B)
    ci = constraint_batched.core_inputs(kind_s, nfacet, *[torch.as_tensor(a) for a in args])
    J, aref, Deq, Done, Dfr, floss = cg_kernel.solve_inputs(ci["kind"], nfacet, ci["rows"],
                                                            ci["maps"], ci["qvel"])
    Minv = factor_kernel.spd_inverse_plain(ci["qM"])
    qs = torch.linalg.solve(ci["qM"], ci["qfrc_smooth"][..., None])[..., 0]
    return (J, aref, Deq, Done, Dfr, floss, ci["qM"], Minv, qs, ci["qacc_prev"], its)


def _check(host_kernel, args, route):
    *ins, its = args
    for k in (1, 2):
        got, want = _run(host_kernel, (*ins, k), route), cg_kernel.cg_plain(*ins, k)
        for name, g, w in zip(("qacc", "efc_force"), got, want):
            assert chip_smoke.rel_err(g, w) <= chip_smoke.CG_EARLY_TOL, (name, k)
    x, f = _run(host_kernel, args, route)
    x_p, f_p = cg_kernel.cg_plain(*ins, its)
    assert bool(torch.isfinite(x).all() and torch.isfinite(f).all())
    np.testing.assert_allclose(x.numpy(), x_p.numpy(), rtol=2e-3, atol=5e-4)
    np.testing.assert_allclose(f.numpy(), f_p.numpy(), rtol=5e-3, atol=5e-3)
    assert bool((f != 0).any()), "no live row"
    return x, f


@pytest.mark.parametrize("route", [SHARED, DEVICE], ids=["smem_j", "device_j"])
def test_cg_source_on_host_matches_plain_hand(host_kernel, hand_args, route):
    _check(host_kernel, hand_args, route)


def test_cg_source_on_host_routes_agree(host_kernel, hand_args):
    """J in shared memory and J in device memory sum in the same order."""
    a, b = _run(host_kernel, hand_args, SHARED), _run(host_kernel, hand_args, DEVICE)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_cg_source_on_host_matches_plain_wide(host_kernel):
    args = _wide_args()
    assert args[0].shape[1:] == (408, 96)
    _check(host_kernel, args, DEVICE)
