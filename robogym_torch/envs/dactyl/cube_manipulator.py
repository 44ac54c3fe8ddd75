"""Rubik's cube qpos surgery, batched over envs: the perpendicular cube
gives each of its 20 cubelets (8 corners, 12 edges) three hinges (rotx,
roty, rotz: an euler triple) and each of its 6 face centres a driver
hinge. Turning a face composes the face's rotation into the euler triples
of the cubelets on that face now, and advances its driver.

Counterpart of `robogym_tpu/envs/dactyl/cube_manipulator.py` (reference
robogym/envs/dactyl/common/cube_manipulator.py). Every function takes
qpos (B, nq) and per-env arguments (B,); the scramble takes its draws
(`draw_scramble`) so that a caller can feed another generator's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from robogym_torch.mjcf.model import Model
from robogym_torch.utils import rotation as rot

DRIVER_NAMES = [
    "cubelet:driver:neg_x", "cubelet:driver:pos_x",
    "cubelet:driver:neg_y", "cubelet:driver:pos_y",
    "cubelet:driver:neg_z", "cubelet:driver:pos_z",
]
# the driver of (axis, side) is DRIVER_NAMES[axis * 2 + side], side 0 the
# negative face
DRIVER_COORDS = np.array(
    [[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0], [0, 0, -1], [0, 0, 1]],
    np.float64,
)


def _cubelet_names():
    """The 20 cubelets (corners and edges) with their home coordinates in
    {-1, 0, 1}^3, in the reference's naming (cube_manipulator.py:97-141)."""
    out = []
    for i in (-1, 0, 1):
        for j in (-1, 0, 1):
            for k in (-1, 0, 1):
                pieces = []
                for key, v in (("x", i), ("y", j), ("z", k)):
                    if v == -1:
                        pieces.append(f"neg_{key}")
                    elif v == 1:
                        pieces.append(f"pos_{key}")
                if len(pieces) > 1:
                    out.append(("_".join(pieces), np.array([i, j, k], np.float64)))
    return out


@dataclasses.dataclass(frozen=True)
class CubeletIndex:
    """The qpos addresses of a prefixed perpendicular cube."""

    prefix: str
    euler_qpos: np.ndarray     # (20, 3) the rotx, roty, rotz hinges
    coords: np.ndarray         # (20, 3) home coordinates in {-1, 0, 1}
    driver_qpos: np.ndarray    # (6,) in DRIVER_NAMES order

    @classmethod
    def build(cls, model: Model, prefix: str = "cube:") -> "CubeletIndex":
        c = model.const
        jn = c.names["joint"]

        def adr(name):
            return int(c.jnt_qposadr[jn[prefix + name]])

        names = _cubelet_names()
        return cls(
            prefix=prefix,
            euler_qpos=np.asarray([[adr(f"cubelet:rot{a}:{n}") for a in "xyz"]
                                   for n, _ in names], np.int32),
            coords=np.asarray([xyz for _, xyz in names]),
            driver_qpos=np.asarray([adr(n) for n in DRIVER_NAMES], np.int32),
        )


def _ix(ids, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.asarray(ids), dtype=torch.long, device=like.device)


def cubelet_eulers(idx: CubeletIndex, qpos: torch.Tensor) -> torch.Tensor:
    """(B, 20, 3) the cubelets' euler triples."""
    return qpos[:, _ix(idx.euler_qpos, qpos)]


def driver_angles(idx: CubeletIndex, qpos: torch.Tensor) -> torch.Tensor:
    """(B, 6) the face drivers' angles, DRIVER_NAMES order."""
    return qpos[:, _ix(idx.driver_qpos, qpos)]


def rotate_face(idx: CubeletIndex, qpos: torch.Tensor, axis: torch.Tensor, side: torch.Tensor,
                angle: torch.Tensor) -> torch.Tensor:
    """Turn face (axis (B,) in {0, 1, 2}, side (B,) in {0, 1}) of each env
    by angle (B,) rad about +axis (cube_manipulator.py:148-189): the
    cubelets whose current coordinate along the axis is on that side get
    the rotation composed into their matrices, and the face's driver
    advances by the angle."""
    dtype = qpos.dtype
    axis = torch.as_tensor(axis, device=qpos.device).long()
    side = torch.as_tensor(side, device=qpos.device).long()
    angle = rot.normalize_angles(torch.as_tensor(angle, device=qpos.device).to(dtype))
    sidesign = side.to(dtype) * 2.0 - 1.0

    eulers = cubelet_eulers(idx, qpos)                                     # (B, 20, 3)
    mtx = rot.euler2mat(eulers)                                            # (B, 20, 3, 3)
    coords = torch.as_tensor(idx.coords, dtype=dtype, device=qpos.device)
    cur = torch.einsum("bcij,cj->bci", mtx, coords)                        # (B, 20, 3)
    along = torch.gather(cur, 2, axis[:, None, None].expand(-1, cur.shape[1], 1))[..., 0]
    selected = along * sidesign[:, None] > 0.5                             # (B, 20)

    face_euler = torch.nn.functional.one_hot(axis, 3).to(dtype) * angle[:, None]
    R = rot.euler2mat(face_euler)                                          # (B, 3, 3)
    combined = torch.einsum("bij,bcjk->bcik", R, mtx)
    new_eulers = rot.mat2euler(combined)
    out = qpos.clone()
    out[:, _ix(idx.euler_qpos, qpos)] = torch.where(selected[..., None], new_eulers, eulers)
    driver = _ix(idx.driver_qpos, qpos)[axis * 2 + side]                   # (B,)
    rows = torch.arange(qpos.shape[0], device=qpos.device)
    out[rows, driver] = out[rows, driver] + angle
    return out


def snap_cubelets(idx: CubeletIndex, qpos: torch.Tensor) -> torch.Tensor:
    """Each cubelet's rotation matrix rounded to the nearest signed
    permutation (cube_manipulator.py:404-413)."""
    snapped = torch.round(rot.euler2mat(cubelet_eulers(idx, qpos)))
    out = qpos.clone()
    out[:, _ix(idx.euler_qpos, qpos)] = rot.mat2euler(snapped).to(qpos.dtype)
    return out


def soft_align_faces(idx: CubeletIndex, qpos: torch.Tensor) -> torch.Tensor:
    """Every face turned to its nearest straight angle, in DRIVER_NAMES
    order (the reference orders by magnitude; for faces near straight the
    result is the same), then the cubelets snapped
    (cube_manipulator.py:387-413)."""
    angles = driver_angles(idx, qpos)
    diff = rot.normalize_angles(rot.round_to_straight_angles(angles) - angles)
    B = qpos.shape[0]
    for i in range(6):
        full = torch.full((B,), i, dtype=torch.long, device=qpos.device)
        qpos = rotate_face(idx, qpos, full // 2, full % 2, diff[:, i])
    return snap_cubelets(idx, qpos)


def draw_scramble(gen: torch.Generator, n: int, num_steps: int,
                  device=None) -> Dict[str, torch.Tensor]:
    """The draws of `scramble` for n envs, each (n, num_steps): the face's
    axis in {0, 1, 2} and side in {0, 1}, and the turn's sign, True for
    +pi/2."""
    return dict(axis=torch.randint(0, 3, (n, num_steps), generator=gen, device=device),
                side=torch.randint(0, 2, (n, num_steps), generator=gen, device=device),
                sign=torch.rand((n, num_steps), generator=gen, device=device) < 0.5)


def scramble(idx: CubeletIndex, qpos: torch.Tensor,
             draws: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Quarter turns of random faces, one per step of `draws`
    (`draw_scramble`), then the cubelets snapped (the full env's reset
    scramble)."""
    for s in range(draws["axis"].shape[1]):
        sign = torch.where(draws["sign"][:, s], 1.0, -1.0).to(qpos.dtype)
        qpos = rotate_face(idx, qpos, draws["axis"][:, s], draws["side"][:, s],
                           sign * (np.pi / 2))
    return snap_cubelets(idx, qpos)
