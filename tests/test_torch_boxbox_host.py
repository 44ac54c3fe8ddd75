"""The box-box kernel's CUDA source (`robogym_torch/csrc/boxbox.cu`, kernel
E) run on the CPU and held against its plain version, as
tests/test_torch_hull_host.py holds the hull kernels: compiled by the
host's C++ compiler against the stand-in CUDA runtime of
`tests/host_cuda/`, each launch block after block and warp after warp,
each warp as 32 threads that meet at a barrier for every shuffle and
__syncwarp, in IEEE single precision without contracted multiply-adds,
through the library's own C entry point (`tests/host_cuda/run_boxbox.cpp`).

Inputs: the three cases of tests/test_torch_kernels.py (`_box_cases`:
random poses, blocks stacked on a table and on each other, an exact
three-way tie of the SAT depth), the box-box call of one goal-settle
substep at B=4 (K=15; the table's z axis ties with each resting block's),
pair counts that are not a multiple of a block's pairs (B=3, K=5 and one
pair), and degenerate boxes whose SAT depths are NaN at axis 0 or at later
axes, or whose cross axes are all degenerate (`_degenerate`). The runner
fails where the kernel writes past the last pair. Tolerance 0: every output
equal bit for bit to the plain version's (NaN where it is NaN), with no
allowance; none was needed.
"""

import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_common import settle_state
from robogym_torch.physics import step as t_step
from robogym_torch.physics.collision import boxbox_kernel as t_bb
from test_torch_kernels import _box_cases

import chip_smoke

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "robogym_torch", "csrc")


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The runner of the box-box kernel built for the host; skips without
    g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to run the CUDA source on the host")
    out = tmp_path_factory.mktemp("host_boxbox")
    with open(os.path.join(CSRC, "boxbox.cu")) as f:
        src = f.read()
    src, n = re.subn(r"(\w+)<<<([^<>]*)>>>\(", r"host_launch(\1, \2, ", src)
    assert n == 1
    (out / "boxbox_host.cpp").write_text(src)
    exe = out / "run_boxbox"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off",
                    "-Wno-unknown-pragmas", f"-I{out}", f"-I{os.path.join(HERE, 'host_cuda')}",
                    "-o", str(exe), os.path.join(HERE, "host_cuda", "run_boxbox.cpp")],
                   check=True, capture_output=True, text=True)
    return str(exe), out


def _run(host_kernel, args):
    """The host build on (xp1, xm1, s1, xp2, xm2, s2): dist (B, K, 17),
    pos (B, K, 17, 3), normal (B, K, 3)."""
    exe, tmp = host_kernel
    B, K = args[0].shape[:2]
    fin, fout = str(tmp / "in.bin"), str(tmp / "out.bin")
    with open(fin, "wb") as f:
        np.array([B * K], np.int32).tofile(f)
        for a in args:
            a = np.asarray(a, np.float32).ravel()
            np.array([a.size], np.int64).tofile(f)
            a.tofile(f)
    subprocess.run([exe, fin, fout], check=True)
    flat = np.split(np.fromfile(fout, np.float32), np.cumsum([B * K * w for w in (17, 51)]))
    return [torch.as_tensor(x).reshape((B, K) + s) for x, s in zip(flat, ((17,), (17, 3), (3,)))]


def _same(got, want) -> bool:
    """Equal bit for bit where a number, NaN where the other is NaN."""
    return got.shape == want.shape and bool(((got == want) | (got.isnan() & want.isnan())).all())


def _check(host_kernel, args):
    """The host build against `boxbox_plain`, every output bit for bit."""
    args = tuple(torch.as_tensor(np.asarray(a, np.float32)) for a in args)
    dist, pos, n = _run(host_kernel, args)
    want = t_bb.boxbox_plain(*args)
    assert _same(n, want[2][..., 0, :]), "the normals differ"
    assert _same(dist, want[0]), "the candidates' distances differ"
    assert _same(pos, want[1]), "the candidates' positions differ"
    return dist, n


@pytest.mark.parametrize("case", ["random", "stack", "tie"])
def test_boxbox_source_on_host_matches_plain_cases(host_kernel, case):
    """The cases of tests/test_torch_kernels.py (B=4, K=6)."""
    _check(host_kernel, _box_cases()[case])


@pytest.fixture(scope="module")
def settle_args():
    ms, ds = settle_state(4)
    return chip_smoke.capture_call(t_bb, "boxbox", lambda: t_step.fwd_position(ms, ds))


def test_boxbox_source_on_host_settle(host_kernel, settle_args):
    """The box-box call of one goal-settle substep at B=4 (K=15), where the
    table's z axis ties exactly with each resting block's: the first of
    the tied axes must win, as in the plain version."""
    dist, _ = _check(host_kernel, settle_args)
    assert bool((dist < 0).any()), "no penetrating candidate in the settle call"


@pytest.mark.parametrize("shape", [(3, 5), (1, 1)], ids=["B3K5", "B1K1"])
def test_boxbox_source_on_host_tail(host_kernel, shape):
    """Pair counts that are not a multiple of a block's pairs: 15 (the
    last warp holds one pair, so its other group repeats it) and 1 (one
    warp of the block has a pair, the others none); the runner fails a
    kernel that writes past the last pair."""
    B, K = shape
    _check(host_kernel, tuple(a[:B, :K] for a in _box_cases()["random"]))


def _degenerate():
    """Boxes whose SAT depths are not all finite, and what they exercise
    (B=1, K=5):
    - pair 0: a NaN half-size of box 1 makes every depth NaN, so axis 0's
      NaN stays the running minimum;
    - pair 1: box 2's first axis is (inf, 0, 0): every depth is inf or NaN
      (inf times 0), and axis 0's inf wins over the later NaNs and infs;
    - pair 2: the boxes share their axes: exact ties of the smallest depth
      (axes 2, 5, 7 and 9) and degenerate cross axes (kBig);
    - pair 3: axis-aligned box 1 with its x axis scaled by 1e30, box 2
      turned about z with its z axis scaled by 1e10: cross axis 8
      overflows to a NaN depth, between finite depths before and after it,
      and a zero-length cross axis (depth 0) wins;
    - pair 4: box 1's x axis scaled by 1e30 and box 2 3e38 away along x:
      axis 0's depth is inf - inf, a NaN that stays the running minimum
      although axis 1's depth is finite."""
    args = [a[:1, :5].copy() for a in _box_cases()["random"]]
    xp1, xm1, s1, xp2, xm2, s2 = args
    s1[0, 0, 1] = np.nan
    xm2[0, 1, :, 0] = (np.inf, 0.0, 0.0)
    xm2[0, 2] = xm1[0, 2]
    c, s = np.cos(0.5), np.sin(0.5)
    xp1[0, 3], xp2[0, 3] = 0.0, (0.03, 0.02, 0.01)
    xm1[0, 3] = np.diag([1e30, 1.0, 1.0])
    xm2[0, 3] = ((c, -s, 0.0), (s, c, 0.0), (0.0, 0.0, 1e10))
    s1[0, 3], s2[0, 3] = 0.05, 0.05
    xp1[0, 4], xp2[0, 4] = 0.0, (3e38, 0.01, 0.01)
    xm1[0, 4], xm2[0, 4] = np.diag([1e30, 1.0, 1.0]), np.eye(3)
    return xp1, xm1, s1, xp2, xm2, s2


def test_boxbox_source_on_host_degenerate(host_kernel):
    """NaN and degenerate SAT depths (`_degenerate`): the group argmin
    picks the plain version's axis, whose strict running minimum keeps a
    NaN at axis 0, never takes a later NaN, and lets a degenerate cross
    axis (kBig) lose to any finite depth."""
    _check(host_kernel, _degenerate())
