"""The hull kernels' CUDA source (`robogym_torch/csrc/hull_sweep.cu`) run
on the CPU and held against their plain versions, as
tests/test_torch_cg_host.py holds kernel F: compiled by the host's C++
compiler against the stand-in CUDA runtime of `tests/host_cuda/`, each
launch block after block and warp after warp, each warp as 32 threads that
meet at a barrier for every shuffle and __syncwarp, in IEEE single
precision without contracted multiply-adds, through the library's own C
entry points (`tests/host_cuda/run_hull.cpp`).

C and H (the manifold) and D and G (the hull pair), one sweep by a group
of 8 lanes a pair, on three inputs: the hull winners of a locked-like
substep at B=2, the table world's two `hull_manifold` calls (box-mesh and
mesh-mesh, `test_torch_hull_world._table_manifold_calls`), and the five
cases of tests/test_torch_hull_world.py (random hulls at V=16 and 64, the
three cube cases); and D and G on the branches that the locked-like winners
do not reach (`test_hull_pair_source_on_host_branches`). The runner fails
where a kernel writes past the last pair. Tolerance 0: every output equal
bit for bit to the plain version's, but for one allowance. Where a witness
is the centroid of three or more verts (a box face along the normal), the
kernel sums them in another order than `torch.sum` does, and that witness,
the contact points and depths made from it may differ in their last bits:
such pairs are held to 1e-5 and counted, and the chosen normal must still
be bit-equal.

The plain version here normalises with a correctly rounded square root
(float64, rounded to float32: `_ieee_norm`), as `sqrtf` is in the kernel
and `torch.sqrt` is on the card: PyTorch's float32 `sqrt` on the CPU is not
correctly rounded in every case (sqrt(0.12817317) comes out one ulp low),
which moves a centre line, and the ring candidates made from it, by an ulp
in one mesh-mesh pair of the table world.
"""

import functools
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from _torch_common import hull_inputs, locked_like_model, locked_like_state
from robogym_torch.physics.collision import convex_kernel as t_ck
from test_torch_hull_world import CASES, _case, _table_manifold_calls, _xd

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "robogym_torch", "csrc")
ENTRIES = ("hull_manifold", "hull_manifold_world", "hull_pair", "hull_pair_world")
TIE_TOL = 1e-5        # chip_smoke.hull_readings' tolerance where directions agree


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The runner of the hull kernels built for the host; skips without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs a C++20 compiler (g++) to run the CUDA source on the host")
    out = tmp_path_factory.mktemp("host_hull")
    with open(os.path.join(CSRC, "hull_sweep.cu")) as f:
        src = f.read()
    launches = src.count("<<<")
    src, n = re.subn(r"(\w+(?:<[^<>]*>)?)<<<([^<>]*)>>>\(", r"host_launch(\1, \2, ", src)
    assert n == launches > 0
    src = src.replace("  extern __shared__ float4 cvs[];\n", "")
    (out / "hull_host.cpp").write_text(src)
    exe = out / "run_hull"
    subprocess.run([cxx, "-std=c++20", "-O1", "-pthread", "-ffp-contract=off",
                    "-Wno-unknown-pragmas", f"-I{out}", f"-I{os.path.join(HERE, 'host_cuda')}",
                    "-o", str(exe), os.path.join(HERE, "host_cuda", "run_hull.cpp")],
                   check=True, capture_output=True, text=True)
    return str(exe), out


def _run(host_kernel, name, args, DX):
    """Entry `name` of the host build on its operands (CPU tensors)."""
    exe, tmp = host_kernel
    world = name.endswith("_world")
    B, K, _, V1 = args[0].shape
    V2 = args[1 if world else 3].shape[-1]
    fin, fout = str(tmp / "in.bin"), str(tmp / "out.bin")
    with open(fin, "wb") as f:
        np.array([ENTRIES.index(name), B * K, V1, V2, args[-1].shape[2], DX],
                 np.int32).tofile(f)
        for a in (*args, t_ck._dir_table("cpu")):
            a = a.numpy().astype(np.float32).ravel()
            np.array([a.size], np.int64).tofile(f)
            a.tofile(f)
    subprocess.run([exe, fin, fout], check=True)
    widths = (4, 12, 3) if name.startswith("hull_manifold") else (1, 3, 3, 3)
    flat = np.split(np.fromfile(fout, np.float32), np.cumsum([B * K * w for w in widths])[:-1])
    shapes = ((4,), (4, 3), (3,)) if len(widths) == 3 else ((), (3,), (3,), (3,))
    return [torch.as_tensor(x).reshape((B, K) + s) for x, s in zip(flat, shapes)]


def _witness_ties(name, args, n):
    """(B, K): pairs where a witness point, along the chosen normal n, is
    the centroid of three or more verts of its side."""
    v1, v2, c1, c2 = (args if name.endswith("_world") else
                      (t_ck.world_from_loc(*args[0:3]), t_ck.world_from_loc(*args[3:6]),
                       *args[6:8]))[:4]
    nb = t_ck._bf(n)[..., None, :]
    tied = torch.zeros(n.shape[:-1], dtype=torch.bool)
    for v, c, sign in ((v1, c1, 1.0), (v2, c2, -1.0)):
        d = sign * t_ck._bf_dots(nb, t_ck._bf(v - c[..., None]))[..., 0, :]
        tied |= (d >= d.amax(-1, keepdim=True)).sum(-1) >= 3
    return tied


def _ieee_norm(a, keepdim=False):
    """`convex_kernel._norm` with a correctly rounded square root: the
    float64 root of a float32 value rounds to the float32 root exactly."""
    n = torch.sqrt(t_ck._dot3(a, a).double()).float()
    return n[..., None] if keepdim else n


def _check(host_kernel, name, args, DX):
    """The host build of entry `name` against its plain version (with
    `_ieee_norm`); returns (pairs that differ in any bit, pairs with a
    witness tie, pairs)."""
    got = _run(host_kernel, name, args, DX)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_ck, "_norm", _ieee_norm)
        want = getattr(t_ck, name + "_plain")(*args, DX)
    assert torch.equal(got[2], want[2]), "the chosen normals differ"
    ties = _witness_ties(name, args, want[2])
    off = torch.zeros_like(ties)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        diff = (g != w).reshape(off.shape + (-1,)).any(-1)
        off |= diff
        err = (g - w).abs().reshape(off.shape + (-1,)).amax(-1)
        assert bool((err[diff] <= TIE_TOL).all()), float(err.max())
    assert not bool((off & ~ties).any()), "outputs differ where no witness ties"
    return int(off.sum()), int(ties.sum()), off.numel()


@functools.lru_cache(maxsize=1)
def _locked_calls():
    tm = locked_like_model()
    calls = hull_inputs(tm, locked_like_state(tm, 2, seed=0))
    for name in ("hull_manifold", "hull_pair"):
        args, DX = calls[name]
        calls[name + "_world"] = ((t_ck.world_from_loc(*args[0:3]),
                                   t_ck.world_from_loc(*args[3:6]), *args[6:9]), DX)
    return calls


@pytest.mark.parametrize("name", ENTRIES)
def test_hull_source_on_host_matches_plain_locked(host_kernel, name):
    """C, H, D and G on the hull winners of a locked-like substep at B=2
    (C and H: K=24, V1=8, V2=64, DX=6; D and G: K=8, V=64)."""
    args, DX = _locked_calls()[name]
    off, ties, total = _check(host_kernel, name, args, DX)
    print(f"{name}: {off} of {total} pairs differ in some bit, {ties} with a witness tie")


def test_hull_source_on_host_world_equals_local(host_kernel):
    """H and G on the verts that `world_from_loc` places equal C and D on
    the local operands bit for bit, as on the card (`world_vs_local`)."""
    calls = _locked_calls()
    for name in ("hull_manifold", "hull_pair"):
        loc = _run(host_kernel, name, *calls[name])
        world = _run(host_kernel, name + "_world", *calls[name + "_world"])
        assert all(torch.equal(a, b) for a, b in zip(loc, world)), name


@pytest.mark.parametrize("call", [0, 1], ids=["box_mesh", "mesh_mesh"])
def test_hull_source_on_host_matches_plain_table(host_kernel, call):
    """C and H on the table world's two manifold calls at B=4: the box-mesh
    group (V1=8, V2=64, DX=6) and the mesh-mesh group (V1=V2=64, DX=0)."""
    args, DX = _table_manifold_calls()[call]
    _check(host_kernel, "hull_manifold", args, DX)
    world = (t_ck.world_from_loc(*args[0:3]), t_ck.world_from_loc(*args[3:6]), *args[6:9])
    _check(host_kernel, "hull_manifold_world", world, DX)


@pytest.mark.parametrize("kernel", ["hull_pair_world", "hull_manifold_world"])
@pytest.mark.parametrize("case", CASES)
def test_hull_source_on_host_matches_plain_cases(host_kernel, kernel, case):
    """G (DX=0) and H (DX=6, the +-x, +-y, +-z face normals) on the cases
    of tests/test_torch_hull_world.py."""
    manifold = kernel == "hull_manifold_world"
    DX = 6 if manifold else 0
    v1, v2, c1, c2 = _case(case, manifold)
    args = tuple(torch.as_tensor(a) for a in (v1, v2, c1, c2, _xd(c1, DX)))
    _check(host_kernel, kernel, args, DX)


def _pair_branch(case):
    """Operands (args, DX) of D or G (`case` ends in "_world") on a branch
    that the locked-like winners do not reach."""
    world = case.endswith("_world")
    if case.startswith("box_mesh"):
        args, DX = _table_manifold_calls()[0]
    else:
        args, DX = _locked_calls()["hull_pair"]
        if case.startswith("dx6"):
            DX = 6
            args = (*args[:-1], torch.as_tensor(_xd(args[6].numpy(), DX)))
        else:
            args = tuple(torch.cat([a, a[:1]]) for a in args)
    if world:
        args = (t_ck.world_from_loc(*args[0:3]), t_ck.world_from_loc(*args[3:6]), *args[6:9])
    return args, DX


@pytest.mark.parametrize("case", ["dx6", "dx6_world", "box_mesh", "tail", "tail_world"])
def test_hull_pair_source_on_host_branches(host_kernel, case):
    """D and G where the locked-like winners (K=8, V=64, DX=0) do not go:
    stage A's five-a-slot instance (`dx6`: their pairs with the +-x, +-y,
    +-z face normals as DX=6 extra directions), a narrow side 1 through D
    (`box_mesh`: the table world's box-mesh operands, V1=8, V2=64, DX=6),
    and a pair count that is not a multiple of a block's 16 (`tail`: B=3,
    K=8, the third env a copy of the first), where the groups past the
    last pair must write nothing past it."""
    name = "hull_pair_world" if case.endswith("_world") else "hull_pair"
    args, DX = _pair_branch(case)
    off, ties, total = _check(host_kernel, name, args, DX)
    print(f"{case}: {name} at BK={total}, DX={DX}: {off} pairs differ in some bit, "
          f"{ties} with a witness tie")
