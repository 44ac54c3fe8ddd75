"""STL loading, mass properties and convex hulls of meshes (numpy, host).

Counterpart of `robogym_tpu/mjcf/mesh.py`: `load_stl` (binary and ASCII,
vertices deduplicated) and `load_msh` (MuJoCo's legacy binary mesh),
`mesh_volume_com_inertia`, `convex_hull` (at most 64 verts),
`hull_face_planes` (the raycast renderer's face planes), `load_mesh_asset`
(one `<mesh>` of the compiler), `vertices_bounding_box` and
`subdivide_mesh`.
"""

from __future__ import annotations

import os
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


def hull_face_planes(verts: np.ndarray, max_faces: int = 64) -> np.ndarray:
    """Face half-planes of the convex hull of `verts`, for raycast rendering
    (render/raycast.py): rows [nx ny nz off] with n·x + off <= 0 inside.

    Coplanar triangle faces are merged (qhull emits triangulated facets);
    if more than `max_faces` remain, the largest-area faces are kept — the
    render silhouette degrades gracefully while containment stays convex
    (dropping a plane only ever GROWS the shape)."""
    verts = np.asarray(verts, np.float64)
    if len(verts) < 4:
        # degenerate: box the points
        lo, hi = verts.min(0) - 1e-4, verts.max(0) + 1e-4
        eye = np.eye(3)
        return np.concatenate(
            [np.concatenate([eye, -hi[:, None]], 1),
             np.concatenate([-eye, lo[:, None]], 1)]
        )
    try:
        hull = ConvexHull(verts)
    except Exception:
        lo, hi = verts.min(0) - 1e-4, verts.max(0) + 1e-4
        eye = np.eye(3)
        return np.concatenate(
            [np.concatenate([eye, -hi[:, None]], 1),
             np.concatenate([-eye, lo[:, None]], 1)]
        )
    eqs = hull.equations  # (F, 4), n·x + off <= 0 inside, |n| = 1
    # merge coplanar facets (same plane up to tolerance), accumulate area
    areas = {}
    pts = verts[hull.simplices]
    tri_area = 0.5 * np.linalg.norm(
        np.cross(pts[:, 1] - pts[:, 0], pts[:, 2] - pts[:, 0]), axis=1
    )
    kept: list = []
    for i, eq in enumerate(eqs):
        key = tuple(np.round(eq, 5))
        if key in areas:
            areas[key] += tri_area[i]
        else:
            areas[key] = tri_area[i]
            kept.append((key, eq))
    kept.sort(key=lambda ke: -areas[ke[0]])
    planes = np.asarray([eq for _, eq in kept[:max_faces]])
    return planes


def load_msh(path: str):
    """MuJoCo legacy binary .msh: [nvertex, nnormal, ntexcoord, nface] int32
    header then float32 vertex/normal/texcoord blocks and int32 faces
    (the rubik cubelet mesh, assets/xmls/rubik/rubik_perpendicular.xml:89)."""
    with open(path, "rb") as f:
        data = f.read()
    nv, nn, nt, nf = struct.unpack("<4i", data[:16])
    off = 16
    verts = np.frombuffer(data, "<f4", 3 * nv, off).reshape(nv, 3).astype(np.float64)
    off += 12 * nv + 12 * nn + 8 * nt
    faces = np.frombuffer(data, "<i4", 3 * nf, off).reshape(nf, 3).copy()
    return verts.copy(), faces


def load_mesh_asset(path: str, scale: np.ndarray) -> dict:
    """Load one <mesh> asset: raw verts/faces + collision hull + mass props."""
    if path.endswith(".msh"):
        verts, faces = load_msh(path)
    else:
        verts, faces = load_stl(path)
    verts = verts * np.asarray(scale)
    vol, com, inertia = mesh_volume_com_inertia(verts, faces)
    if vol <= 0:
        # flip winding
        faces = faces[:, ::-1]
        vol, com, inertia = mesh_volume_com_inertia(verts, faces)
    hull = convex_hull(verts)
    return dict(
        verts=verts,
        faces=faces,
        volume=vol,
        com=com,
        inertia=inertia,
        hull=hull,
        name=os.path.basename(path),
    )


def vertices_bounding_box(vertices: np.ndarray):
    """(pos, half_size, norm(half_size)) of the vertex AABB
    (reference robogym/utils/mesh.py:7-14 get_vertices_bounding_box)."""
    lo = vertices.min(axis=0)
    hi = vertices.max(axis=0)
    half = (hi - lo) / 2.0
    return lo + half, half, float(np.linalg.norm(half))


def subdivide_mesh(vertices: np.ndarray, faces: np.ndarray,
                   subdivide_threshold: float) -> np.ndarray:
    """Midpoint-subdivide triangles until every edge is shorter than
    norm(bbox_half_size) * subdivide_threshold; returns the new vertex set
    (reference robogym/utils/mesh.py:16-32, trimesh.remesh.subdivide_to_size
    semantics — used to densify sparse meshes before vertex-based goal
    distances). Pure numpy, host-side (runs at env build time)."""
    max_edge = vertices_bounding_box(vertices)[2] * subdivide_threshold
    v = np.asarray(vertices, np.float64)
    f = np.asarray(faces, np.int64).reshape(-1, 3)
    for _ in range(12):  # each pass halves edge lengths; 2^12 headroom
        tri = v[f]                                   # (F, 3, 3)
        e = np.linalg.norm(tri - np.roll(tri, -1, axis=1), axis=2)  # (F, 3)
        too_long = (e > max_edge).any(axis=1)
        if not too_long.any():
            break
        keep, split = f[~too_long], f[too_long]
        # midpoints of the 3 edges of every split face, deduplicated
        pairs = np.concatenate(
            [split[:, [0, 1]], split[:, [1, 2]], split[:, [2, 0]]], axis=0
        )
        pairs.sort(axis=1)
        uniq, inv = np.unique(pairs, axis=0, return_inverse=True)
        mids = (v[uniq[:, 0]] + v[uniq[:, 1]]) / 2.0
        mid_id = len(v) + inv.reshape(3, -1)          # (3, S) new vertex ids
        v = np.concatenate([v, mids], axis=0)
        a, b, c = split[:, 0], split[:, 1], split[:, 2]
        ab, bc, ca = mid_id[0], mid_id[1], mid_id[2]
        f = np.concatenate([
            keep,
            np.stack([a, ab, ca], 1), np.stack([ab, b, bc], 1),
            np.stack([ca, bc, c], 1), np.stack([ab, bc, ca], 1),
        ], axis=0)
    return v.astype(vertices.dtype)
