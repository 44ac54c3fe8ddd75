"""The fused post-gather constraint core.

Counterpart of `robogym_tpu/physics/constraint_batched.py`
(`_make_core(kind, iterations, nfacet, with_euler=True, with_smooth=True)`):
from the gathered contact data it builds the per-row coefficient maps,
then runs the two SPD-inverse kernels (M and M + dt*diag(damping)) and the
fused CG kernel, which builds the contact rows of J in the kernel, solves,
and applies the implicit-damping Euler update.

`contact_rows` and `row_maps` are the plain per-row math
(`_contact_rows_single`, `_row_maps`); `reference` is the whole core in
plain PyTorch, the JAX package's `reference`.
"""

from __future__ import annotations

import numpy as np
import torch

from robogym_torch.mjcf.model import env_col
from robogym_torch.physics import cg_kernel, factor_kernel
from robogym_torch.physics import constraint as cl


def facet_active(act_c: torch.Tensor, cd_sel: torch.Tensor, nfacet: int) -> torch.Tensor:
    """(B, S, F) activity of each pyramid facet row."""
    if nfacet == 1:
        oks = [cd_sel >= 1]
    else:
        oks = [cd_sel >= 3] * 4
        if nfacet >= 6:
            oks += [cd_sel >= 4] * 2
        if nfacet == 10:
            oks += [cd_sel >= 6] * 4
    ok = torch.stack(oks, dim=-1)
    first = torch.zeros(nfacet, dtype=torch.bool, device=ok.device)
    first[0] = True
    return act_c[..., None] & (ok | first)


def row_maps(nfacet, pos_s, solref_s, solimp_s, floss_s, active_s, diagA_s,
             dist_c, margin_c, solref_c, solimp_c, active_cf, iw_c):
    """Per-row coefficient maps (B, E): pos, kimp, bref, rdiag, active,
    floss; rdiag = (1-imp)/imp * diagApprox is MuJoCo's regularizer R."""
    F = nfacet
    B = dist_c.shape[0]
    pos_con = torch.repeat_interleave(dist_c - margin_c, F, dim=-1)
    pos = torch.cat([pos_s, pos_con], dim=-1)
    solref = torch.cat([solref_s, torch.repeat_interleave(solref_c, F, dim=-2)], dim=-2)
    solimp = torch.cat([solimp_s, torch.repeat_interleave(solimp_c, F, dim=-2)], dim=-2)
    floss = torch.cat([floss_s, torch.zeros_like(pos_con)], dim=-1)
    active = torch.cat([active_s, active_cf.reshape(B, -1).to(pos.dtype)], dim=-1)
    imp = cl._impedance(solimp, pos)
    k_ref, b_ref = cl._ref_kb(solref, solimp)
    kimp = k_ref * imp
    diagA = torch.cat([diagA_s.expand(B, -1), torch.repeat_interleave(iw_c, F, dim=-1)], dim=-1)
    rdiag = torch.clamp(torch.clamp((1.0 - imp) / imp, min=1e-8) * diagA, min=1e-12)
    return pos, kimp, b_ref, rdiag, active, floss


def row_inputs(kind_s, nfacet, J_s, pos_s, solref_s, solimp_s, floss_s, active_s, diagA_s,
               pos_c, frame_c, dist_c, margin_c, fric_c, act_c, cd_sel, iw_c, mask1, mask2,
               rc1, rc2, solref_c, solimp_c, cdof, qvel, qM):
    """What the CG kernel takes of the gathered data: the full row kinds,
    the contact row data and per-row maps, qM and qvel."""
    S, B = pos_c.shape[1], pos_c.shape[0]
    active_cf = facet_active(act_c, cd_sel, nfacet)
    pos, kimp, bref, rdiag, active, floss = row_maps(
        nfacet, pos_s, solref_s, solimp_s, floss_s, active_s, diagA_s,
        dist_c, margin_c, solref_c, solimp_c, active_cf, iw_c)
    rows = dict(
        Js=J_s.contiguous(), off1=(pos_c - rc1).contiguous(), off2=(pos_c - rc2).contiguous(),
        frame=frame_c.reshape(B, S, 9).contiguous(), fric=fric_c.contiguous(),
        m1=mask1.contiguous(), m2=mask2.contiguous(), cdof=cdof.contiguous(),
    )
    return dict(
        kind=np.concatenate([kind_s, np.full(S * nfacet, cl.ONESIDED, np.int32)]),
        rows=rows, maps=dict(pos=pos, kimp=kimp, bref=bref, rcoef=rdiag, active=active,
                             floss=floss),
        qM=qM.contiguous(), qvel=qvel,
    )


def core_inputs(kind_s, nfacet, *args):
    """What the kernels of the fused core take: `row_inputs`, and M +
    dt*diag(damp) for the second SPD inverse and the dof vectors. `args`
    are `row_inputs`' after `nfacet`, then qfrc_smooth, qacc_prev, damp
    (B, V) and dt (0-dim, or (B,) each env's)."""
    *head, qfrc_smooth, qacc_prev, damp, dt = args
    ci = row_inputs(kind_s, nfacet, *head)
    ci.update(Mimp=(ci["qM"] + env_col(dt, 2) * torch.diag_embed(damp)).contiguous(),
              qfrc_smooth=qfrc_smooth, qacc_prev=qacc_prev, dt=dt)
    return ci


def _core(kind_s, iterations, nfacet, args, spd_inverse, cg_full):
    ci = core_inputs(kind_s, nfacet, *args)
    Minv = spd_inverse(ci["qM"])
    Minv_imp = spd_inverse(ci["Mimp"])
    x, f, qfrc, qvel_new, qs = cg_full(
        ci["kind"], iterations, nfacet, ci["rows"], ci["maps"], ci["qM"], Minv, ci["Mimp"],
        Minv_imp, ci["qvel"], ci["qfrc_smooth"], ci["qacc_prev"], ci["dt"])
    return x, qfrc, f, qvel_new, qs


def fused_step_core(kind_s, iterations, nfacet, *args):
    """The core through the kernel wrappers. `args` are those of
    `core_inputs` after `nfacet`. Returns (qacc, qfrc_constraint,
    efc_force, qvel_new, qacc_smooth)."""
    return _core(kind_s, iterations, nfacet, args, factor_kernel.spd_inverse, cg_kernel.cg_full)


def reference(kind_s, iterations, nfacet, *args):
    """The whole core in plain PyTorch on any device (the kernels' plain
    versions): the same arguments and returns as `fused_step_core`."""
    return _core(kind_s, iterations, nfacet, args, factor_kernel.spd_inverse_plain,
                 cg_kernel.cg_full_plain)


def _solve(kind_s, iterations, nfacet, args, cg_full_noeuler):
    *head, Minv, qs, x0 = args
    ci = row_inputs(kind_s, nfacet, *head)
    x, f, qfrc = cg_full_noeuler(ci["kind"], iterations, nfacet, ci["rows"], ci["maps"],
                                 ci["qM"], Minv.contiguous(), ci["qvel"], qs, x0)
    return x, qfrc, f


def solve_core(kind_s, iterations, nfacet, *args):
    """The core without the Euler update, through the kernel wrapper.
    `args` are `row_inputs`' after `nfacet`, then Minv (B, V, V), qacc_smooth
    and the warmstart (B, V). Returns (qacc, qfrc_constraint, efc_force)."""
    return _solve(kind_s, iterations, nfacet, args, cg_kernel.cg_full_noeuler)


def solve_reference(kind_s, iterations, nfacet, *args):
    """`solve_core` in plain PyTorch on any device."""
    return _solve(kind_s, iterations, nfacet, args, cg_kernel.cg_full_noeuler_plain)
