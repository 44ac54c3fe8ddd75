"""Batched rotation math in PyTorch: the part of `robogym_tpu/utils/rotation.py`
that the physics step calls.

Conventions are the JAX package's (and MuJoCo's): quaternions are
[w, x, y, z]; every function broadcasts over leading batch dimensions.
"""

from __future__ import annotations

import numpy as np
import torch

_FLOAT_EPS = float(np.finfo(np.float64).eps)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, with broadcasting."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim))


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    w, x, y, z = quat[..., 0], quat[..., 1], quat[..., 2], quat[..., 3]
    nq = torch.sum(quat * quat, dim=-1)
    s = 2.0 / torch.where(nq > _FLOAT_EPS, nq, torch.ones_like(nq))
    X, Y, Z = x * s, y * s, z * s
    wX, wY, wZ = w * X, w * Y, w * Z
    xX, xY, xZ = x * X, x * Y, x * Z
    yY, yZ, zZ = y * Y, y * Z, z * Z
    row0 = torch.stack([1.0 - (yY + zZ), xY - wZ, xZ + wY], dim=-1)
    row1 = torch.stack([xY + wZ, 1.0 - (xX + zZ), yZ - wX], dim=-1)
    row2 = torch.stack([xZ - wY, yZ + wX, 1.0 - (xX + yY)], dim=-1)
    mat = torch.stack([row0, row1, row2], dim=-2)
    eye = torch.eye(3, dtype=mat.dtype, device=mat.device).expand(mat.shape)
    return torch.where((nq > _FLOAT_EPS)[..., None, None], mat, eye)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_mul(q0: torch.Tensor, q1: torch.Tensor) -> torch.Tensor:
    w0, x0, y0, z0 = q0[..., 0], q0[..., 1], q0[..., 2], q0[..., 3]
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w = w0 * w1 - x0 * x1 - y0 * y1 - z0 * z1
    x = w0 * x1 + x0 * w1 + y0 * z1 - z0 * y1
    y = w0 * y1 + y0 * w1 + z0 * x1 - x0 * z1
    z = w0 * z1 + z0 * w1 + x0 * y1 - y0 * x1
    return torch.stack([w, x, y, z], dim=-1)


def quat_rot_vec(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    u = q[..., 1:]
    w = q[..., :1]
    uv = cross(u, v)
    return v + 2.0 * (w * uv + cross(u, uv))


def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    """Flip sign so w >= 0 (not unit-norming)."""
    sign = torch.sign(q[..., :1])
    sign = torch.where(sign == 0, torch.ones_like(sign), sign)
    return q * sign


def quat_unit(q: torch.Tensor) -> torch.Tensor:
    """Normalize to unit length (mju_normalize4)."""
    n = norm(q, keepdim=True)
    ident = quat_identity(q.dtype, q.device).expand(q.shape)
    return torch.where(n > 0, q / torch.clamp(n, min=1e-15), ident)


def quat_from_angle_and_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    axis = axis / norm(axis, keepdim=True)
    half = angle[..., None] / 2.0
    axis, half = torch.broadcast_tensors(axis, half)
    quat = torch.cat([torch.cos(half[..., :1]), axis * torch.sin(half)], dim=-1)
    return quat_unit(quat)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """q' = q * exp(0.5 * omega * dt), omega in the local frame
    (mju_quatIntegrate)."""
    wn = norm(omega, keepdim=True)
    angle = wn * dt
    small = angle < 1e-12
    safe = torch.where(small, torch.ones_like(wn), wn)
    axis = omega / safe
    half = angle / 2.0
    dq = torch.cat([torch.cos(half), axis * torch.sin(half)], dim=-1)
    dq = torch.where(small, quat_identity(q.dtype, q.device).expand(dq.shape), dq)
    return quat_unit(quat_mul(q, dq))


def any_orthogonal(vec: torch.Tensor) -> torch.Tensor:
    """An arbitrary unit vector orthogonal to vec."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=vec.dtype, device=vec.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=vec.dtype, device=vec.device)
    helper = torch.where(torch.abs(vec[..., :1]) < 0.5, ex, ey)
    orth = cross(vec, helper)
    return orth / norm(orth, keepdim=True)
