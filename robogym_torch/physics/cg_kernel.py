"""The fused constraint solve: contact rows of J, aref, the regularizer,
M^-1-preconditioned nonlinear CG with the frozen-active-set Newton line
search, J^T f, and the implicit-damping Euler velocity update.

Counterpart of `robogym_tpu/physics/cg_kernel.py::_cg_full_kernel` (with
`_build_rows` and `_line_search_step`). `cg_full` is the wrapper: on CUDA
tensors it launches the hand-written kernel in
`robogym_torch/csrc/cg_full.cu` (one thread block per env, J and the four
mass-matrix tiles in shared memory); on CPU tensors it runs `cg_full_plain`,
the PyTorch transcription of the JAX reference
(`constraint_batched._make_core(...).reference` with `_scan_cg_solve`).

Shapes (per env, leading B): scalar rows Js (n_s, V); contact offsets
off1/off2 (S, 3); frames (S, 9) as [normal | tangent1 | tangent2]; friction
(S, 5); dof path masks m1/m2 (S, V); cdof (V, 6); row maps (E,) with
E = n_s + S*F; M, Minv, Mimp, Minv_imp (V, V); qvel, qfrc_smooth,
qacc_prev (V,); dt a 0-dim tensor.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from robogym_torch.physics import constraint as cl
from robogym_torch.utils.rotation import cross

def contact_rows(off1, off2, frame, fric, m1, m2, cdof, nfacet: int) -> torch.Tensor:
    """Pyramidal facet rows (B, S*F, V) of the contact Jacobian, contact-
    major and facet-minor (`_contact_rows_single`)."""
    B, S = off1.shape[:2]
    ang = cdof[:, None, :, :3]                                          # (B, 1, V, 3)
    lin = cdof[:, None, :, 3:]
    jac1 = (lin + cross(ang, off1[:, :, None, :])) * m1[..., None]       # (B, S, V, 3)
    jac2 = (lin + cross(ang, off2[:, :, None, :])) * m2[..., None]
    Jrel = jac2 - jac1

    def project(row, J3):
        fr = frame[..., 3 * row:3 * row + 3]
        return (fr[..., 0, None] * J3[..., 0] + fr[..., 1, None] * J3[..., 1]) \
            + fr[..., 2, None] * J3[..., 2]

    Jn = project(0, Jrel)
    facets = [Jn]
    if nfacet >= 4:
        Jt1, Jt2 = project(1, Jrel), project(2, Jrel)
        f0, f1 = fric[..., 0:1], fric[..., 1:2]
        facets = [Jn + f0 * Jt1, Jn - f0 * Jt1, Jn + f1 * Jt2, Jn - f1 * Jt2]
    if nfacet >= 6:
        Jr = ang * (m2 - m1)[..., None]
        Jtn = project(0, Jr)
        f2 = fric[..., 2:3]
        facets += [Jn + f2 * Jtn, Jn - f2 * Jtn]
    if nfacet == 10:
        Jr1, Jr2 = project(1, Jr), project(2, Jr)
        f3, f4 = fric[..., 3:4], fric[..., 4:5]
        facets += [Jn + f3 * Jr1, Jn - f3 * Jr1, Jn + f4 * Jr2, Jn - f4 * Jr2]
    return torch.stack(facets, dim=2).reshape(B, S * nfacet, -1)


def _mv(A, x):
    return torch.matmul(A, x.unsqueeze(-1)).squeeze(-1)


def cg_full_plain(kind, iterations, nfacet, rows, maps, M, Minv, Mimp, Minv_imp,
                  qvel, qfrc_smooth, qacc_prev, dt):
    """Plain version of the fused CG kernel. Returns (x, f, qfrc, qvel_new,
    qacc_smooth)."""
    qs = _mv(Minv, qfrc_smooth)
    finite = torch.all(torch.abs(qacc_prev) < 1e10, dim=-1, keepdim=True)
    x0 = torch.where(finite, qacc_prev, qs)
    Jc = contact_rows(rows["off1"], rows["off2"], rows["frame"], rows["fric"],
                      rows["m1"], rows["m2"], rows["cdof"], nfacet)
    J = torch.cat([rows["Js"], Jc], dim=1)
    aref = -maps["bref"] * _mv(J, qvel) - maps["kimp"] * maps["pos"]
    D = torch.where(maps["active"] > 0, 1.0 / maps["rcoef"], torch.zeros_like(maps["rcoef"]))
    Deq, Done, Dfr = cl.kind_masked_D(kind, D)
    x, f = cl._scan_cg_solve(J, aref, Deq, Done, Dfr, maps["floss"], M, Minv, qs, x0, iterations)
    qfrc = _mv(J.transpose(-1, -2), f)
    qfrc_total = _mv(M, x)
    qacc1 = _mv(Minv_imp, qfrc_total)
    qacc_imp = qacc1 + _mv(Minv_imp, qfrc_total - _mv(Mimp, qacc1))
    qvel_new = qvel + dt * qacc_imp
    return x, f, qfrc, qvel_new, qs


@functools.lru_cache(maxsize=64)
def _kind_tensor(kind_key: bytes, device: str) -> torch.Tensor:
    return torch.as_tensor(np.frombuffer(kind_key, np.int32).copy(), device=device)


def cg_full(kind, iterations, nfacet, rows, maps, M, Minv, Mimp, Minv_imp,
            qvel, qfrc_smooth, qacc_prev, dt):
    """The fused constraint solve; the CUDA kernel on CUDA tensors. The
    launch raises when V > 256 or when J and the four (V, V) matrices do not
    fit in one block's shared memory (227 KB; `cuda.cg_full_smem_bytes`)."""
    if M.device.type == "cpu":
        return cg_full_plain(kind, iterations, nfacet, rows, maps, M, Minv, Mimp, Minv_imp,
                             qvel, qfrc_smooth, qacc_prev, dt)
    from robogym_torch import cuda

    dev = M.device
    B, n_s, V = rows["Js"].shape
    S = rows["off1"].shape[1]
    E = n_s + S * nfacet
    want = {
        "Js": (B, n_s, V), "off1": (B, S, 3), "off2": (B, S, 3), "frame": (B, S, 9),
        "fric": (B, S, 5), "m1": (B, S, V), "m2": (B, S, V), "cdof": (B, V, 6),
    }
    ops = [(k, rows[k], s) for k, s in want.items()]
    ops += [(k, maps[k], (B, E)) for k in ("pos", "kimp", "bref", "rcoef", "active", "floss")]
    ops += [(k, t, (B, V, V)) for k, t in (("M", M), ("Minv", Minv), ("Mimp", Mimp),
                                           ("Minv_imp", Minv_imp))]
    ops += [(k, t, (B, V)) for k, t in (("qvel", qvel), ("qfrc_smooth", qfrc_smooth),
                                        ("qacc_prev", qacc_prev))]
    for name, t, shape in ops:
        if (tuple(t.shape) != shape or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"cg_full operand {name}: {tuple(t.shape)} {t.dtype} {t.device}, "
                             f"want a contiguous {shape} float32 tensor on {dev}")
    if len(kind) != E:
        raise ValueError(f"cg_full: {len(kind)} row kinds for {E} rows")
    if nfacet not in (1, 4, 6, 10):
        raise ValueError(f"cg_full: nfacet {nfacet}")
    kind_t = _kind_tensor(np.asarray(kind, np.int32).tobytes(), str(dev))
    dt_t = torch.as_tensor(dt, dtype=torch.float32, device=dev).reshape(1)
    x = torch.empty((B, V), dtype=torch.float32, device=dev)
    f = torch.empty((B, E), dtype=torch.float32, device=dev)
    qfrc = torch.empty_like(x)
    qvel_new = torch.empty_like(x)
    qs = torch.empty_like(x)
    cuda.launch("cg_full", *[t for _, t, _ in ops], kind_t, dt_t, x, f, qfrc, qvel_new, qs,
                B, n_s, S, nfacet, V, iterations)
    return x, f, qfrc, qvel_new, qs
