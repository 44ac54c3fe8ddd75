"""Kernel A's CUDA source (`robogym_torch/csrc/spd_inverse.cu`) run on the
CPU and held against its plain version, as tests/test_torch_cg_host.py
holds kernel F: compiled by the host's C++ compiler against the stand-in
CUDA runtime of `tests/host_cuda/`, each launch block after block, each
block's threads all running together (a block barrier for
__syncthreads, each warp's own barrier and exchange arrays for its
shuffles and __syncwarp), in IEEE single precision without contracted
multiply-adds, through the library's own C entry point
(`tests/host_cuda/run_spd.cpp`).

Inputs: the locked-like world's M and M + dt*diag(damping) from one
substep (V=30, B=3), the hand world's M (V=24), and seeded random SPD
matrices at V in {1, 5, 8, 24, 30, 32, 33, 36, 40, 48, 64, 65, 96, 128,
129, 160, 200}, which cover the padding and every instance of the kernel
(Vp = 8 to 32, a row a lane; 40 to 64, two rows a lane; above 64 dofs one
env a block of 8, 16 or 32 warps, the matrix in shared memory; above 128
also held to a float64 inverse at 1e-3 of its largest entry), and the
dactyl-shaped world's M (V=36). Tolerances, chip_smoke.py's: 1e-5
relative to the plain version's largest entry (`SPD_TOL`), and each
column's error against a float64 inverse, over that column's largest
entry, at most 4 times the plain version's in the batch's worst column
(`SPD_COLUMN_RATIO`); the output bit-symmetric. On the input of
tests/test_factor_kernel.py (V=30) the host build and the JAX package's
Pallas kernel in interpret mode are held to `np.linalg.inv` with that
file's tolerances and to each other at 1e-5 relative, and so they are on
the dactyl-shaped world's M (V=36, the kernel's Vp = 40 instance).

Above 64 dofs the host build is held bit for bit (`np.array_equal`) to
`_transcription`, the kernel's arithmetic per element written out in
float32 numpy, at V in {65, 96, 128, 129, 160, 200, 240, 256} (240 the
largest V in shared memory, 256 through device memory); the device-memory
entry to the shared-memory one bit for bit at V=96 and V=160; and neither
route reads the strict upper triangle."""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_common import core_inputs, hand_state, locked_like_model, locked_like_state
from robogym_torch.physics import constraint_batched, factor_kernel
from robogym_torch.mjcf.model import make_data
from robogym_torch.physics import step as t_step
from robogym_torch.worlds import dactyl_locked_like
from test_torch_kernels import _spd
from _torch_common import snapshot_arrays, snapshot_model

import chip_smoke

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "robogym_torch", "csrc")
B = 3


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The runner of kernel A built for the host; skips without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to run the CUDA source on the host")
    out = tmp_path_factory.mktemp("host_spd")
    with open(os.path.join(CSRC, "spd_inverse.cu")) as f:
        src = f.read()
    launches = src.count("<<<")
    src, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<([^<>]*)>>>\(", r"host_launch(\1, \2, ", src)
    assert n == launches > 0
    shared = "  extern __shared__ float4 smem[];\n"
    assert shared in src
    (out / "spd_host.cpp").write_text(src.replace(shared, ""))
    exe = out / "run_spd"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off",
                    "-Wno-unknown-pragmas", f"-I{out}", f"-I{os.path.join(HERE, 'host_cuda')}",
                    "-o", str(exe), os.path.join(HERE, "host_cuda", "run_spd.cpp")],
                   check=True, capture_output=True, text=True)
    return str(exe), out


def _run(host_kernel, A, dev=False):
    """Kernel A of the host build on (B, V, V) float32 matrices, through
    its entry point, or with `dev` through the block kernel's in device
    memory (`robogym_spd_inverse_dev`, any V)."""
    exe, tmp = host_kernel
    A = np.ascontiguousarray(np.asarray(A, np.float32))
    Bn, V, _ = A.shape
    fin, fout = str(tmp / "in.bin"), str(tmp / "out.bin")
    with open(fin, "wb") as f:
        np.array([Bn, V, int(dev)], np.int32).tofile(f)
        A.tofile(f)
    subprocess.run([exe, fin, fout], check=True)
    return torch.as_tensor(np.fromfile(fout, np.float32).reshape(Bn, V, V))


def _check(host_kernel, A):
    got, want = _run(host_kernel, A), factor_kernel.spd_inverse_plain(A)
    ref = factor_kernel.spd_inverse_plain(A.double())
    assert bool(torch.isfinite(got).all())
    assert chip_smoke.rel_err(got, want) <= chip_smoke.SPD_TOL
    assert (chip_smoke.column_err(got, ref)
            <= chip_smoke.SPD_COLUMN_RATIO * chip_smoke.column_err(want, ref))
    assert torch.equal(got, got.transpose(1, 2)), "output not bit-symmetric"
    return got


@pytest.fixture(scope="module")
def locked_like_core():
    tm = locked_like_model()
    kind_s, _, nfacet, args = core_inputs(tm, locked_like_state(tm, B, seed=0))
    return constraint_batched.core_inputs(kind_s, nfacet, *args)


@pytest.mark.parametrize("name", ["qM", "Mimp"])
def test_spd_source_on_host_matches_plain_locked_like(host_kernel, locked_like_core, name):
    A = locked_like_core[name]
    assert A.shape == (B, 30, 30)
    _check(host_kernel, A)


def test_spd_source_on_host_matches_plain_hand(host_kernel):
    tm, d = hand_state(B)
    A = chip_smoke.capture_call(factor_kernel, "spd_inverse", lambda: t_step.step(tm, d))[0]
    assert A.shape == (B, 24, 24)
    _check(host_kernel, A)


@pytest.fixture(scope="module")
def dactyl_core():
    """M and M + dt*diag(damping) of one substep of the dactyl-shaped world
    from seeded start states settled for 5 substeps (B=3, V=36)."""
    tm = snapshot_model(dactyl_locked_like.SNAPSHOT)
    qpos, ctrl = dactyl_locked_like.initial_state(snapshot_arrays(dactyl_locked_like.SNAPSHOT),
                                                  B, 0)
    d = make_data(tm, B, torch.as_tensor(qpos)).replace(ctrl=torch.as_tensor(ctrl))
    d = t_step.step_n(tm, d, 5)
    return chip_smoke.capture_calls(factor_kernel, "spd_inverse", lambda: t_step.step(tm, d))


@pytest.mark.parametrize("call", [0, 1], ids=["qM", "Mimp"])
def test_spd_source_on_host_matches_plain_dactyl(host_kernel, dactyl_core, call):
    A = dactyl_core[call][0]
    assert A.shape == (B, 36, 36)
    _check(host_kernel, A)


def test_spd_source_on_host_matches_pallas_dactyl(host_kernel, dactyl_core):
    """The host build and the Pallas kernel in interpret mode on the
    dactyl-shaped world's M (V=36, padded to 40 by both)."""
    import jax.numpy as jnp
    from robogym_tpu.physics import factor_kernel as j_fk

    M = dactyl_core[0][0]
    old = j_fk.INTERPRET
    j_fk.INTERPRET = True
    try:
        pallas = torch.as_tensor(np.array(j_fk.spd_inverse_batched(jnp.asarray(M.numpy()))))
    finally:
        j_fk.INTERPRET = old
    got = _check(host_kernel, M)
    assert chip_smoke.rel_err(got, pallas) <= chip_smoke.SPD_TOL


@pytest.mark.parametrize("V", [1, 5, 8, 24, 30, 32, 33, 36, 40, 48, 64, 65, 96, 128,
                               129, 160, 200])
def test_spd_source_on_host_matches_plain_random(host_kernel, V):
    A = torch.as_tensor(_spd(np.random.default_rng(V), B, V))
    got = _check(host_kernel, A)
    if V > 128:
        ref = torch.linalg.inv(A.double())
        assert float((got.double() - ref).abs().max() / ref.abs().max()) <= 1e-3


def test_spd_source_on_host_device_memory_matches_shared_memory(host_kernel):
    """The device-memory entry at V=96 and V=160 gives the shared-memory
    kernel's outputs bit for bit: the same block body in device memory,
    at 32 warps a block against 8 and 16 in shared memory."""
    for V in (96, 160):
        A = torch.as_tensor(_spd(np.random.default_rng(V), B, V))
        assert torch.equal(_run(host_kernel, A, dev=True), _run(host_kernel, A)), V


def _transcription(A):
    """Kernel A's arithmetic above 64 dofs, element by element, in float32
    numpy on (B, V, V) matrices: the Cholesky's rank-1 updates as a
    multiply and then a subtraction in ascending j after the clamped square
    root and the division; the substitution's updates in ascending i (from
    0.0 below the diagonal), then the division (1 / d on the diagonal); the
    product's sums over i >= max(r, c) in ascending i from 0.0."""
    A = np.asarray(A, np.float32)
    Bn, V, _ = A.shape
    a = np.tril(A)
    L = np.zeros_like(A)
    d = np.zeros((Bn, V), np.float32)
    for j in range(V):
        d[:, j] = np.sqrt(np.maximum(a[:, j, j], np.float32(1e-20)))
        L[:, j + 1:, j] = a[:, j + 1:, j] / d[:, j, None]
        l = L[:, j + 1:, j]
        a[:, j + 1:, j + 1:] -= np.tril(l[:, :, None] * l[:, None, :])
    X = np.zeros_like(A)
    X[:, np.arange(V), np.arange(V)] = np.float32(1.0) / d
    for i in range(V - 1):
        X[:, i + 1:, :i + 1] -= L[:, i + 1:, i, None] * X[:, i, None, :i + 1]
        X[:, i + 1, :i + 1] /= d[:, i + 1, None]
    out = np.zeros_like(A)
    k = np.arange(V)
    first = np.maximum(k[:, None], k[None, :])
    for i in range(V):
        out = np.where(i >= first, out + X[:, i, :, None] * X[:, i, None, :], out)
    return out


@pytest.mark.parametrize("V", [65, 96, 128, 129, 160, 200, 240, 256])
def test_spd_source_on_host_matches_transcription(host_kernel, V):
    """Above 64 dofs the host build gives `_transcription`'s outputs bit for
    bit, through shared memory up to V=240 and device memory at 256."""
    A = _spd(np.random.default_rng(V), B, V)
    assert np.array_equal(_run(host_kernel, A).numpy(), _transcription(A))


@pytest.mark.parametrize("V", [96, 241])
def test_spd_source_on_host_wide_reads_lower_triangle(host_kernel, V):
    """Above 64 dofs, in shared memory (V=96) and in device memory (V=241),
    the strict upper triangle is never read either."""
    A = torch.as_tensor(_spd(np.random.default_rng(V), B, V))
    junk = A + torch.triu(torch.full_like(A, 1e3), diagonal=1)
    assert torch.equal(_run(host_kernel, junk), _run(host_kernel, A))


def test_spd_source_on_host_reads_lower_triangle(host_kernel):
    """The strict upper triangle is never read, as torch's Cholesky."""
    A = torch.as_tensor(_spd(np.random.default_rng(7), B, 30))
    junk = A + torch.triu(torch.full_like(A, 1e3), diagonal=1)
    assert torch.equal(_run(host_kernel, junk), _run(host_kernel, A))


def test_spd_source_on_host_matches_pallas(host_kernel):
    """The host build and the JAX package's Pallas kernel in interpret mode
    on the input of tests/test_factor_kernel.py (B=8, V=30)."""
    import jax.numpy as jnp
    from robogym_tpu.physics import factor_kernel as j_fk

    rng = np.random.default_rng(1)
    A = rng.standard_normal((8, 30, 30)).astype(np.float32)
    M = A @ np.swapaxes(A, 1, 2) + 2.0 * np.eye(30, dtype=np.float32)
    old = j_fk.INTERPRET
    j_fk.INTERPRET = True
    try:
        pallas = np.array(j_fk.spd_inverse_batched(jnp.asarray(M)))
    finally:
        j_fk.INTERPRET = old
    got = _check(host_kernel, torch.as_tensor(M)).numpy()
    ref = np.linalg.inv(M)
    np.testing.assert_allclose(got, ref, rtol=2e-3, atol=2e-4)
    np.testing.assert_allclose(pallas, ref, rtol=2e-3, atol=2e-4)
    assert chip_smoke.rel_err(torch.as_tensor(got), torch.as_tensor(pallas)) <= chip_smoke.SPD_TOL
