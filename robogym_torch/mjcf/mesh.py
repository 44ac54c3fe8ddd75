"""STL loading, mass properties and convex hulls of meshes (numpy, host).

Counterpart of the parts of `robogym_tpu/mjcf/mesh.py` that the mesh
object bank needs (`envs/rearrange/mesh.py`): `load_stl` (binary and ASCII,
vertices deduplicated), `mesh_volume_com_inertia` and `convex_hull`.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np
from scipy.spatial import ConvexHull


def load_stl(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Load an STL file -> (verts (n,3) float64, faces (m,3) int32).

    Handles both binary and ASCII STL. Vertices are deduplicated.
    """
    with open(path, "rb") as f:
        header = f.read(84)
        if len(header) < 84 or header[:5].lower() == b"solid":
            # could still be binary with 'solid' header; check size
            f.seek(0)
            data = f.read()
            if _looks_binary(data):
                return _parse_binary(data)
            return _parse_ascii(data.decode("ascii", errors="ignore"))
        f.seek(0)
        return _parse_binary(f.read())


def _looks_binary(data: bytes) -> bool:
    if len(data) < 84:
        return False
    (ntri,) = struct.unpack("<I", data[80:84])
    return len(data) == 84 + 50 * ntri


def _parse_binary(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    (ntri,) = struct.unpack("<I", data[80:84])
    raw = np.frombuffer(data, dtype=np.uint8, count=50 * ntri, offset=84)
    raw = raw.reshape(ntri, 50)
    tri = raw[:, 12:48].copy().view("<f4").reshape(ntri, 3, 3).astype(np.float64)
    return _dedup(tri)


def _parse_ascii(text: str) -> Tuple[np.ndarray, np.ndarray]:
    verts = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("vertex"):
            verts.append([float(x) for x in line.split()[1:4]])
    tri = np.asarray(verts, dtype=np.float64).reshape(-1, 3, 3)
    return _dedup(tri)


def _dedup(tri: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    flat = tri.reshape(-1, 3)
    # quantize to dedup within float32 noise
    keys = np.round(flat * 1e8).astype(np.int64)
    uniq, inverse = np.unique(keys, axis=0, return_inverse=True)
    # take the first occurrence's exact coordinates
    order = np.argsort(inverse, kind="stable")
    first_mask = np.ones(len(order), dtype=bool)
    first_mask[1:] = inverse[order][1:] != inverse[order][:-1]
    verts = flat[order[first_mask]]
    faces = inverse.reshape(-1, 3).astype(np.int32)
    return verts, faces


def mesh_volume_com_inertia(
    verts: np.ndarray, faces: np.ndarray
) -> Tuple[float, np.ndarray, np.ndarray]:
    """Exact volume, center of mass and unit-density inertia tensor of a closed
    triangle mesh via the divergence theorem (per-tetra accumulation against
    the origin). Returns (volume, com (3,), inertia (3,3) about com)."""
    a = verts[faces[:, 0]]
    b = verts[faces[:, 1]]
    c = verts[faces[:, 2]]
    det = np.einsum("ij,ij->i", a, np.cross(b, c))  # 6 * signed tetra volume
    vol = det.sum() / 6.0
    if abs(vol) < 1e-12:
        # degenerate/open mesh: fall back to hull
        hull = ConvexHull(verts)
        return mesh_volume_com_inertia(verts, hull.simplices.astype(np.int32))
    com = (det[:, None] * (a + b + c)).sum(axis=0) / (24.0 * vol)

    # canonical tetra inertia accumulation
    def _sub(p, q, r, i, j):
        return (
            p[:, i] * p[:, j]
            + q[:, i] * q[:, j]
            + r[:, i] * r[:, j]
            + 0.5 * (p[:, i] * q[:, j] + q[:, i] * p[:, j])
            + 0.5 * (p[:, i] * r[:, j] + r[:, i] * p[:, j])
            + 0.5 * (q[:, i] * r[:, j] + r[:, i] * q[:, j])
        )

    # products of inertia over the solid, unit density
    P = np.zeros((3, 3))
    for i in range(3):
        for j in range(3):
            P[i, j] = (det * _sub(a, b, c, i, j)).sum() / 60.0
    trace = np.trace(P)
    inertia_origin = trace * np.eye(3) - P
    # parallel-axis to com
    m = vol
    r = com
    inertia_com = inertia_origin - m * ((r @ r) * np.eye(3) - np.outer(r, r))
    return float(vol), com, inertia_com


def convex_hull(verts: np.ndarray, max_verts: int = 64) -> np.ndarray:
    """Convex hull vertices of a point cloud, decimated to <= max_verts by
    greedy farthest-point selection (keeps support-function accuracy for GJK)."""
    if len(verts) > 3:
        try:
            hull = ConvexHull(verts)
            hv = verts[hull.vertices]
        except Exception:
            hv = verts
    else:
        hv = verts
    if len(hv) <= max_verts:
        return np.asarray(hv, dtype=np.float64)
    # farthest point sampling
    sel = [int(np.argmax(np.linalg.norm(hv - hv.mean(0), axis=1)))]
    d = np.linalg.norm(hv - hv[sel[0]], axis=1)
    for _ in range(max_verts - 1):
        nxt = int(np.argmax(d))
        sel.append(nxt)
        d = np.minimum(d, np.linalg.norm(hv - hv[nxt], axis=1))
    return np.asarray(hv[sel], dtype=np.float64)
