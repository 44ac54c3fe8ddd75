"""Batched rotation math in PyTorch: the part of `robogym_tpu/utils/rotation.py`
that the physics step, the dactyl env and its wrappers call.

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


def quat_difference(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return quat_normalize(quat_mul(q, quat_conjugate(p)))


def quat_magnitude(q: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.arccos(torch.clamp(q[..., 0], -1.0, 1.0))


def vectors2quat(v_from: torch.Tensor, v_to: torch.Tensor) -> torch.Tensor:
    """Minimal rotation taking v_from to v_to (w >= 0, unit norm)."""
    v_from, v_to = torch.broadcast_tensors(v_from, v_to)
    dot = torch.sum(v_from * v_to, dim=-1, keepdim=True)
    w = torch.sqrt(torch.clamp(torch.sum(v_from ** 2, dim=-1, keepdim=True)
                               * torch.sum(v_to ** 2, dim=-1, keepdim=True), min=0.0)) + dot
    q = torch.cat([w, cross(v_from, v_to)], dim=-1)
    # antiparallel: a half turn about any orthogonal axis
    q_pi = torch.cat([torch.zeros_like(w), any_orthogonal(v_from)], dim=-1)
    q = torch.where(w <= 1e-9, q_pi, q)
    return quat_normalize(quat_unit(q))


def normalize_angles(angles: torch.Tensor, low=-np.pi, high=np.pi) -> torch.Tensor:
    """Angles wrapped into [low, high)."""
    return torch.remainder(angles - low, high - low) + low


def round_to_straight_angles(angles: torch.Tensor) -> torch.Tensor:
    """Angles rounded to the nearest multiple of pi/2 (half to even, as
    `jnp.round`), wrapped into [-pi, pi)."""
    return normalize_angles(torch.round(angles / (np.pi / 2)) * (np.pi / 2))


def round_to_straight_quat(quat: torch.Tensor) -> torch.Tensor:
    """The quaternion whose euler angles are `quat`'s rounded to multiples
    of pi/2."""
    return euler2quat(round_to_straight_angles(quat2euler(quat)))


def rot_z_aligned(cube_quat: torch.Tensor, quat_threshold, include_flip: bool = True):
    """(...,) whether each cube orientation is within `quat_threshold` of a
    rotation about z (or, with `include_flip`, of one followed by a half
    turn about x)."""
    angles = quat2euler(cube_quat)
    target = angles * torch.tensor([0.0, 0.0, 1.0], dtype=angles.dtype, device=angles.device)
    x_flip = torch.tensor([np.pi, 0.0, 0.0], dtype=angles.dtype, device=angles.device)
    ok = quat_magnitude(quat_difference(cube_quat, euler2quat(target))) < quat_threshold
    if include_flip:
        ok = ok | (quat_magnitude(quat_difference(cube_quat, euler2quat(target + x_flip)))
                   < quat_threshold)
    return ok


def rot_xyz_aligned(cube_quat: torch.Tensor, quat_threshold) -> torch.Tensor:
    """(...,) whether some local axis of each cube points straight up (or
    down), within `quat_threshold`."""
    z_up = torch.tensor([0.0, 0.0, 1.0], dtype=cube_quat.dtype, device=cube_quat.device)
    mtx = quat2mat(cube_quat)
    dots = mtx[..., 2, :]                   # each local axis's world z
    axis_nr = torch.argmax(torch.abs(dots), dim=-1)
    axis = torch.gather(mtx, -1, axis_nr[..., None, None].expand(mtx.shape[:-1] + (1,)))[..., 0]
    axis = axis * torch.sign(axis[..., 2:3])
    return quat_magnitude(vectors2quat(axis, z_up.expand(axis.shape))) < quat_threshold


def quat_average2(q1: torch.Tensor, q2: torch.Tensor, w1: torch.Tensor) -> torch.Tensor:
    """Weighted average of two unit quaternions (..., 4) with weights w1
    (...,) and 1 - w1: q2 sign-aligned to q1, then the chordal mean with w
    >= 0 (the JAX package's `quat_average2`)."""
    q2 = torch.where(torch.sum(q1 * q2, dim=-1, keepdim=True) < 0, -q2, q2)
    w1 = w1[..., None]
    return quat_normalize(w1 * q1 + (1.0 - w1) * q2)


def uniform_quat_apply(u: torch.Tensor) -> torch.Tensor:
    """A uniform random unit quaternion from three uniform draws in [0, 1)
    (..., 3): s, then the two angles over 2 pi (`uniform_quat`)."""
    s, a1, a2 = u[..., 0], u[..., 1], u[..., 2]
    s1, s2 = torch.sqrt(1.0 - s), torch.sqrt(s)
    t1, t2 = 2.0 * np.pi * a1, 2.0 * np.pi * a2
    return quat_normalize(torch.stack(
        [torch.cos(t2) * s2, torch.sin(t1) * s1, torch.cos(t1) * s1, torch.sin(t2) * s2], dim=-1))


def random_unity2_apply(u: torch.Tensor) -> torch.Tensor:
    """Uniform random unit 3-vectors (..., 3) from two uniform draws in
    [0, 1) (..., 2), computed in u's dtype: the azimuth in [0, 2 pi), then
    the polar angle's cosine in [-1, 1) (`random_unity2`)."""
    phi = torch.clamp(u[..., 0] * (2.0 * np.pi), min=0.0)
    costheta = torch.clamp(u[..., 1] * 2.0 - 1.0, min=-1.0)
    sintheta = torch.sqrt(torch.clamp(1.0 - costheta ** 2, min=0.0))
    return torch.stack([sintheta * torch.cos(phi), sintheta * torch.sin(phi), costheta], dim=-1)


def uniform_z_quat_apply(u: torch.Tensor) -> torch.Tensor:
    """Rotations about z at angles uniform in [-pi, pi) from draws u (...,)
    in [0, 1), computed in u's dtype (`uniform_z_quat`)."""
    angle = torch.maximum(torch.as_tensor(-np.pi, dtype=u.dtype, device=u.device),
                          u * (2.0 * np.pi) - np.pi)
    return quat_from_angle_and_axis(angle, torch.tensor([0.0, 0.0, 1.0], dtype=u.dtype,
                                                        device=u.device))


def euler2mat(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) -> rotation matrix (..., 3, 3) (the JAX
    package's `euler2mat`: R = R_x(e0) R_y(e1) R_z(e2), the composition of
    MuJoCo hinges about x, y and z listed in that order in one body)."""
    ai, aj, ak = -euler[..., 2], -euler[..., 1], -euler[..., 0]
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    row0 = torch.stack([cj * ci, cj * si, -sj], dim=-1)
    row1 = torch.stack([sj * cs - sc, sj * ss + cc, cj * sk], dim=-1)
    row2 = torch.stack([sj * cc + ss, sj * sc - cs, cj * ck], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def euler2quat(euler: torch.Tensor) -> torch.Tensor:
    """Euler angles (..., 3) -> quaternion [w, x, y, z] (the JAX package's
    `euler2quat`)."""
    ai, aj, ak = euler[..., 2] / 2.0, -euler[..., 1] / 2.0, euler[..., 0] / 2.0
    si, sj, sk = torch.sin(ai), torch.sin(aj), torch.sin(ak)
    ci, cj, ck = torch.cos(ai), torch.cos(aj), torch.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    return torch.stack([cj * cc + sj * ss, cj * cs - sj * sc, -(cj * ss + sj * cc),
                        cj * sc - sj * cs], dim=-1)


def mat2euler(mat: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> euler angles (the JAX package's
    `mat2euler`)."""
    cy = torch.sqrt(mat[..., 2, 2] ** 2 + mat[..., 1, 2] ** 2)
    condition = cy > _FLOAT_EPS * 4.0
    e2 = torch.where(condition, -torch.atan2(mat[..., 0, 1], mat[..., 0, 0]),
                     -torch.atan2(-mat[..., 1, 0], mat[..., 1, 1]))
    e1 = -torch.atan2(-mat[..., 0, 2], cy)
    e0 = torch.where(condition, -torch.atan2(mat[..., 1, 2], mat[..., 2, 2]),
                     torch.zeros_like(cy))
    return torch.stack([e0, e1, e2], dim=-1)


def mat2quat(mat: torch.Tensor) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) to quaternions with w >= 0 by
    Shepperd's four branches, selected per element (the JAX package's
    `mat2quat`)."""
    m00, m01, m02 = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    m10, m11, m12 = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    m20, m21, m22 = mat[..., 2, 0], mat[..., 2, 1], mat[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(v):
        return torch.sqrt(torch.clamp(v, min=1e-18))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)
    q = torch.where((tr > 0.0)[..., None], q0, torch.where(
        ((m00 >= m11) & (m00 >= m22))[..., None], q1, torch.where((m11 >= m22)[..., None], q2, q3)))
    return quat_normalize(q / norm(q, keepdim=True))


def quat2euler(quat: torch.Tensor) -> torch.Tensor:
    return mat2euler(quat2mat(quat))


def uniform_quat(gen: torch.Generator, n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """(n, 4) uniform random unit quaternions drawn from `gen`."""
    u = torch.rand((n, 3), generator=gen, dtype=dtype, device=device)
    return uniform_quat_apply(u)


def get_parallel_rotations() -> np.ndarray:
    """The 24 rotations that map a cube onto itself, as (24, 4) float64
    unit quaternions, sign-normalised (host-side numpy)."""
    return _unique_euler_quats([0, np.pi / 2, -np.pi / 2, np.pi], expect=24)


def get_parallel_rotations_180() -> np.ndarray:
    """The 4 of them made of multiples of pi, as (4, 4) float64."""
    return _unique_euler_quats([0, np.pi], expect=4)


def _np_euler2mat(euler: np.ndarray) -> np.ndarray:
    """Host-side euler -> mat (the JAX package's `euler2mat` convention)."""
    ai, aj, ak = -euler[2], -euler[1], -euler[0]
    si, sj, sk = np.sin(ai), np.sin(aj), np.sin(ak)
    ci, cj, ck = np.cos(ai), np.cos(aj), np.cos(ak)
    cc, cs = ci * ck, ci * sk
    sc, ss = si * ck, si * sk
    mat = np.empty((3, 3))
    mat[0, 0] = cj * ck
    mat[0, 1] = sj * sc - cs
    mat[0, 2] = sj * cc + ss
    mat[1, 0] = cj * sk
    mat[1, 1] = sj * ss + cc
    mat[1, 2] = sj * cs - sc
    mat[2, 0] = -sj
    mat[2, 1] = cj * si
    mat[2, 2] = cj * ci
    return mat


def _np_mat2quat(mat: np.ndarray) -> np.ndarray:
    """Host-side mat -> quat (the eigenvector method), w >= 0."""
    Qxx, Qyx, Qzx = mat[0, 0], mat[0, 1], mat[0, 2]
    Qxy, Qyy, Qzy = mat[1, 0], mat[1, 1], mat[1, 2]
    Qxz, Qyz, Qzz = mat[2, 0], mat[2, 1], mat[2, 2]
    K = np.array([
        [Qxx - Qyy - Qzz, 0, 0, 0],
        [Qyx + Qxy, Qyy - Qxx - Qzz, 0, 0],
        [Qzx + Qxz, Qzy + Qyz, Qzz - Qxx - Qyy, 0],
        [Qyz - Qzy, Qzx - Qxz, Qxy - Qyx, Qxx + Qyy + Qzz],
    ]) / 3.0
    vals, vecs = np.linalg.eigh(K)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    if q[0] < 0:
        q = -q
    return q


def _unique_euler_quats(vals, expect: int) -> np.ndarray:
    """The distinct rotations (up to a quaternion's sign) of every euler
    triple over `vals`."""
    quats: list = []
    for e1 in vals:
        for e2 in vals:
            for e3 in vals:
                q = _np_mat2quat(_np_euler2mat(np.array([e1, e2, e3], dtype=np.float64)))
                q = np.where(np.abs(q) < 1e-9, 0.0, q)
                if q[np.argmax(np.abs(q))] < 0:
                    q = -q
                q /= np.linalg.norm(q)
                if not any(np.allclose(q, e, atol=1e-7) or np.allclose(q, -e, atol=1e-7)
                           for e in quats):
                    quats.append(q)
    out = np.array(quats)
    assert out.shape == (expect, 4), out.shape
    return out
