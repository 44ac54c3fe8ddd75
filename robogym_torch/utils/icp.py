"""Iterative closest point, batched: a brute-force nearest neighbour and an
SVD fit, for the "icp" rotational distance of the rearrange goals.

Counterpart of `robogym_tpu/utils/icp.py`. Every function takes leading
batch dimensions (envs, objects) on its point clouds; the iteration count is
fixed, as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch

from robogym_torch.utils import rotation as rot


def best_fit_transform(A: torch.Tensor, B: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The least-squares rigid transform that maps A (..., n, 3) onto B:
    (R (..., 3, 3), t (..., 3))."""
    ca, cb = A.mean(-2), B.mean(-2)
    H = (A - ca[..., None, :]).transpose(-1, -2) @ (B - cb[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.sign(torch.linalg.det(V @ Ut))
    ones = torch.ones_like(d)
    R = V @ torch.diag_embed(torch.stack([ones, ones, d], -1)) @ Ut
    t = cb - (R @ ca[..., None])[..., 0]
    return R, t


def nearest_neighbor(src: torch.Tensor, dst: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each point of src (..., n, 3)'s nearest point of dst (..., m, 3),
    by brute force: (distance (..., n), index (..., n))."""
    d2 = ((src[..., :, None, :] - dst[..., None, :, :]) ** 2).sum(-1)
    idx = torch.argmin(d2, dim=-1)
    return torch.sqrt(torch.gather(d2, -1, idx[..., None])[..., 0]), idx


def _homogeneous(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    T = torch.eye(4, dtype=R.dtype, device=R.device).expand(R.shape[:-2] + (4, 4)).clone()
    T[..., :3, :3] = R
    T[..., :3, 3] = t
    return T


def icp(A: torch.Tensor, B: torch.Tensor, max_iterations: int = 20
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """ICP aligning A (..., n, 3) to B (..., m, 3) over `max_iterations`
    rounds: (T (..., 4, 4), the last round's mean distance (...))."""
    src = torch.cat([A, torch.ones_like(A[..., :1])], -1)
    err = None
    for _ in range(max_iterations):
        dist, idx = nearest_neighbor(src[..., :3], B)
        matched = torch.gather(B, -2, idx[..., None].expand(idx.shape + (3,)))
        R, t = best_fit_transform(src[..., :3], matched)
        src = src @ _homogeneous(R, t).transpose(-1, -2)
        err = dist.mean(-1)
    R, t = best_fit_transform(A, src[..., :3])
    return _homogeneous(R, t), err


def icp_rotation_distance(verts: torch.Tensor, q1: torch.Tensor, q2: torch.Tensor,
                          max_iterations: int = 20) -> torch.Tensor:
    """(...,) the angle of the rotation that ICP finds between a vertex
    cloud verts (..., n, 3) turned by q1 (..., 4) and by q2."""
    A = verts @ rot.quat2mat(q1).transpose(-1, -2)
    B = verts @ rot.quat2mat(q2).transpose(-1, -2)
    T, _ = icp(A, B, max_iterations)
    return rot.quat_magnitude(rot.quat_normalize(rot.mat2quat(T[..., :3, :3])))
