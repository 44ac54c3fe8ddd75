"""Batched SPD inverse: M^-1 and (M + dt*damping)^-1, twice per substep.

Counterpart of `robogym_tpu/physics/factor_kernel.py`. `spd_inverse` is
the wrapper: on a CUDA tensor it launches the hand-written kernel in
`robogym_torch/csrc/spd_inverse.cu` (one warp per env, one or two rows or
columns a lane in registers up to V = 64: right-looking Cholesky, forward
substitution for L^-1, A^-1 = L^-T L^-1, with identity on the dofs padded
up to a multiple of 8; above 64 dofs the same arithmetic per element on
one env a block of 8 to 32 warps, the matrix in shared memory up to 240
dofs and in a scratch in device memory above, so that it takes any V, as
the JAX package's kernel does); on a CPU tensor it runs
`spd_inverse_plain`,
the PyTorch transcription of the JAX reference `_spd_inverse_ref`. Both
read only the lower triangle.
"""

from __future__ import annotations

import torch


def spd_inverse_plain(A: torch.Tensor) -> torch.Tensor:
    """(B, V, V) SPD -> (B, V, V) inverse via Cholesky and a triangular
    solve (the JAX package's `_spd_inverse_ref`)."""
    L = torch.linalg.cholesky_ex(A).L
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    return torch.matmul(Linv.transpose(-1, -2), Linv)


def spd_inverse(A: torch.Tensor) -> torch.Tensor:
    """(B, V, V) float32 SPD matrices -> their inverses."""
    if A.device.type == "cpu":
        return spd_inverse_plain(A)
    from robogym_torch import cuda

    if A.dim() != 3 or A.shape[1] != A.shape[2] or A.dtype != torch.float32 or not A.is_contiguous():
        raise ValueError(f"spd_inverse takes a contiguous (B, V, V) float32 tensor, got "
                         f"{tuple(A.shape)} {A.dtype}")
    B, V, _ = A.shape
    out = torch.empty_like(A)
    cuda.launch("spd_inverse", A, out, B, V)
    return out
