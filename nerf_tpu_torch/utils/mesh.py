"""Iso-surface mesh extraction from a NeRF density field + PLY/OBJ export.

The port's copy of ``nerf_tpu/utils/mesh.py`` (numpy only; the reference's
``src/utils/mesh_utils.py:8`` uses mcubes and trimesh, which are not
installed): marching tetrahedra, each voxel split into 6 tetrahedra and the
iso-crossings linearly interpolated; (query_fn, level, bbox, N) -> mesh.
"""
from __future__ import annotations

from typing import Callable, Tuple

import numpy as np

# 6-tetrahedra decomposition of a cube (corner indices, consistent winding)
_TETS = np.array(
    [[0, 5, 1, 6], [0, 1, 2, 6], [0, 2, 3, 6],
     [0, 3, 7, 6], [0, 7, 4, 6], [0, 4, 5, 6]], np.int64
)
# cube corner offsets (x, y, z)
_CORNERS = np.array(
    [[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0],
     [0, 0, 1], [1, 0, 1], [1, 1, 1], [0, 1, 1]], np.int64
)


def _tet_triangles(verts: np.ndarray, vals: np.ndarray, level: float):
    """March one batch of tetrahedra.

    verts: [T, 4, 3] corner positions; vals: [T, 4] field values.
    Returns triangle vertices [M, 3, 3].
    """
    inside = vals > level  # [T, 4]
    case = (inside * np.array([1, 2, 4, 8])).sum(-1)  # [T]

    def interp(a_idx, b_idx, sel):
        va, vb = vals[sel, a_idx], vals[sel, b_idx]
        t = (level - va) / np.where(np.abs(vb - va) < 1e-12, 1e-12, vb - va)
        t = np.clip(t, 0.0, 1.0)[:, None]
        return verts[sel, a_idx] + t * (verts[sel, b_idx] - verts[sel, a_idx])

    tris = []
    # single-corner cases (corner k inside or its complement)
    combos = {
        1: (0, 1, 2, 3), 2: (1, 0, 3, 2), 4: (2, 0, 1, 3), 8: (3, 0, 2, 1),
    }
    for code, (a, b, c, d) in combos.items():
        for cs, flip in ((code, False), (15 ^ code, True)):
            sel = case == cs
            if not sel.any():
                continue
            p0 = interp(a, b, sel)
            p1 = interp(a, c, sel)
            p2 = interp(a, d, sel)
            tri = np.stack([p0, p2, p1] if flip else [p0, p1, p2], axis=1)
            tris.append(tri)
    # two-corner (edge) cases: {a,b} inside -> quad
    edge_combos = {
        3: (0, 1, 2, 3), 5: (0, 2, 3, 1), 9: (0, 3, 1, 2),
        6: (1, 2, 0, 3), 10: (1, 3, 2, 0), 12: (2, 3, 0, 1),
    }
    for code, (a, b, c, d) in edge_combos.items():
        sel = case == code
        if not sel.any():
            continue
        # quad corners: ac, ad, bd, bc
        pac = interp(a, c, sel)
        pad = interp(a, d, sel)
        pbd = interp(b, d, sel)
        pbc = interp(b, c, sel)
        tris.append(np.stack([pac, pad, pbd], axis=1))
        tris.append(np.stack([pac, pbd, pbc], axis=1))
    if not tris:
        return np.zeros((0, 3, 3), np.float32)
    return np.concatenate(tris, axis=0).astype(np.float32)


def marching_tetrahedra(
    field: np.ndarray, level: float,
    bbox_min: np.ndarray, bbox_max: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """field: [N, N, N] -> (vertices [V, 3], faces [F, 3])."""
    field = np.asarray(field, np.float32)
    n = field.shape[0]
    spacing = (np.asarray(bbox_max) - np.asarray(bbox_min)) / (n - 1)

    # corner values for every voxel: [n-1, n-1, n-1, 8]
    idx = np.stack(np.meshgrid(*[np.arange(n - 1)] * 3, indexing="ij"), -1)
    idx = idx.reshape(-1, 1, 3) + _CORNERS[None]  # [C, 8, 3]
    vals = field[idx[..., 0], idx[..., 1], idx[..., 2]]  # [C, 8]
    pos = bbox_min + idx.astype(np.float32) * spacing  # [C, 8, 3]

    # keep voxels straddling the level
    straddle = (vals > level).any(-1) & (vals <= level).any(-1)
    vals, pos = vals[straddle], pos[straddle]

    # expand into tetrahedra
    tv = pos[:, _TETS]  # [C, 6, 4, 3]
    tf = vals[:, _TETS]  # [C, 6, 4]
    tris = _tet_triangles(tv.reshape(-1, 4, 3), tf.reshape(-1, 4), level)

    # weld duplicate vertices
    flat = tris.reshape(-1, 3)
    key = np.round(flat / (spacing.min() * 1e-4)).astype(np.int64)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    verts = np.zeros((len(uniq), 3), np.float32)
    np.add.at(verts, inv, flat)
    counts = np.bincount(inv, minlength=len(uniq)).astype(np.float32)
    verts /= counts[:, None]
    faces = inv.reshape(-1, 3)
    # drop degenerate faces
    ok = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) & (
        faces[:, 0] != faces[:, 2])
    return verts, faces[ok]


def extract_mesh(
    query_fn: Callable[[np.ndarray], np.ndarray],
    level: float = 5.0,
    bbox=((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0)),
    resolution: int = 256,
    chunk: int = 262144,
) -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate ``query_fn([M,3]) -> density [M]`` on a grid, then march.

    Same surface as reference mesh_utils.extract_mesh (mcubes/trimesh free).
    """
    bbox_min = np.asarray(bbox[0], np.float32)
    bbox_max = np.asarray(bbox[1], np.float32)
    axes = [np.linspace(bbox_min[d], bbox_max[d], resolution) for d in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    out = np.concatenate([
        np.asarray(query_fn(grid[i : i + chunk].astype(np.float32)))
        for i in range(0, len(grid), chunk)
    ])
    field = out.reshape(resolution, resolution, resolution)
    return marching_tetrahedra(field, level, bbox_min, bbox_max)


def save_ply(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(verts)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        f.write(np.asarray(verts, "<f4").tobytes())
        face_block = np.empty(len(faces), dtype=[("n", "u1"), ("v", "<i4", 3)])
        face_block["n"] = 3
        face_block["v"] = faces
        f.write(face_block.tobytes())


def save_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces + 1:
            f.write(f"f {face[0]} {face[1]} {face[2]}\n")
