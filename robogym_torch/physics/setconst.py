"""Compile-time derived constants (MuJoCo mj_setConst): the *_invweight0
values MuJoCo's diagApprox regularizer draws from.

Counterpart of `robogym_tpu/physics/setconst.py`: the smooth position stage
runs once at qpos0, in the model's dtype, on the CPU, and the inverse is
taken in float64 numpy.
"""

from __future__ import annotations

import numpy as np
import torch

from robogym_torch.mjcf.model import JointType, Model, make_data


def compute_invweight0(m: Model):
    """(dof_invweight0 (nv,), body_invweight0 (nbody, 2),
    tendon_invweight0 (ntendon,)) at qpos0, as float64 numpy."""
    from robogym_torch.bridge import model_to
    from robogym_torch.physics import smooth

    c = m.const
    if c.nv == 0:
        return np.zeros(0), np.zeros((c.nbody, 2)), np.zeros(c.ntendon)
    mc = model_to(m, "cpu")
    d = make_data(mc, 1)
    d = smooth.kinematics(mc, d)
    d = smooth.com_pos(mc, d)
    d = smooth.crb(mc, d)
    d = smooth.tendon(mc, d)

    Minv = np.linalg.inv(d.qM[0].numpy().astype(np.float64))
    dof_iw = np.diag(Minv).copy()
    for j in range(c.njnt):
        jt = int(c.jnt_type[j])
        adr = int(c.jnt_dofadr[j])
        if jt == JointType.FREE:
            dof_iw[adr:adr + 3] = dof_iw[adr:adr + 3].mean()
            dof_iw[adr + 3:adr + 6] = dof_iw[adr + 3:adr + 6].mean()
        elif jt == JointType.BALL:
            dof_iw[adr:adr + 3] = dof_iw[adr:adr + 3].mean()

    body_iw = np.zeros((c.nbody, 2))
    for b in range(1, c.nbody):
        Jt = smooth.point_jacobian(mc, d, d.xipos[:, b], b)[0].numpy().astype(np.float64)
        Jr = smooth.rotation_jacobian(mc, d, b)[0].numpy().astype(np.float64)
        body_iw[b, 0] = np.trace(Jt @ Minv @ Jt.T) / 3.0
        body_iw[b, 1] = np.trace(Jr @ Minv @ Jr.T) / 3.0

    if c.ntendon:
        tj = d.ten_J[0].numpy().astype(np.float64)
        ten_iw = np.einsum("ti,ij,tj->t", tj, Minv, tj)
    else:
        ten_iw = np.zeros(0)
    return dof_iw, body_iw, ten_iw


def invweight0(m: Model):
    """Cached accessor: computed once per ModelConst."""
    c = m.const
    cached = getattr(c, "_invweight0", None)
    if cached is None:
        if m.env_fields:
            raise ValueError("invweight0 is computed from the compiled model, not from one with "
                             f"per-env fields {sorted(m.env_fields)}")
        cached = compute_invweight0(m)
        object.__setattr__(c, "_invweight0", cached)
    return cached


def invweight0_tensors(m: Model):
    """invweight0 as tensors on the model's device and in its dtype."""
    cache = m.__dict__.get("_invweight0_t")
    if cache is None:
        dof_iw, body_iw, ten_iw = invweight0(m)
        cache = tuple(torch.as_tensor(a, dtype=m.dtype, device=m.device)
                      for a in (dof_iw, body_iw, ten_iw))
        object.__setattr__(m, "_invweight0_t", cache)
    return cache
