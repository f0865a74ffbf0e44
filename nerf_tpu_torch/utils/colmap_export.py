"""COLMAP model/database exporters.

The port's copy of ``nerf_tpu/utils/colmap_export.py`` (numpy only). The
reference vendors COLMAP's exporter scripts
(``src/utils/colmap/export_to_bundler.py``, ``export_to_visualsfm.py``,
``export_inlier_matches.py``, ``export_inlier_pairs.py``,
``merge_ply_files.py``); these implement the public Bundler v0.3 and
VisualSFM NVM_V3 text formats, database match export and PLY merging, on
this package's model and database types.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .colmap import Camera, Image, Point3D, qvec2rotmat
from .colmap_database import COLMAPDatabase, pair_id_to_image_ids

# COLMAP camera convention: x right, y down, z forward.
# Bundler convention: x right, y up, z backward -> flip y and z.
_FLIP_YZ = np.diag([1.0, -1.0, -1.0])


def _focal(cam: Camera) -> float:
    # SIMPLE_PINHOLE/SIMPLE_RADIAL: [f, cx, cy(, k)], PINHOLE: [fx, fy, ...]
    if cam.model in ("PINHOLE", "OPENCV"):
        return float(0.5 * (cam.params[0] + cam.params[1]))
    return float(cam.params[0])


def write_bundler(
    path: str,
    cameras: Dict[int, Camera],
    images: Dict[int, Image],
    points: Dict[int, Point3D],
    list_path: str = None,
):
    """Write a Bundler v0.3 ``bundle.out`` (+ image ``list.txt``)."""
    image_ids = sorted(images)
    idx_of = {iid: i for i, iid in enumerate(image_ids)}
    lines = ["# Bundle file v0.3", f"{len(image_ids)} {len(points)}"]
    for iid in image_ids:
        im = images[iid]
        cam = cameras[im.camera_id]
        R = _FLIP_YZ @ qvec2rotmat(im.qvec)
        t = _FLIP_YZ @ np.asarray(im.tvec)
        lines.append(f"{_focal(cam):.10g} 0 0")  # f k1 k2 (undistorted)
        for row in R:
            lines.append(" ".join(f"{v:.10g}" for v in row))
        lines.append(" ".join(f"{v:.10g}" for v in t))
    for p in points.values():
        lines.append(" ".join(f"{v:.10g}" for v in p.xyz))
        lines.append(" ".join(str(int(v)) for v in p.rgb))
        track = [
            f"{idx_of[int(iid)]} {int(kidx)} 0 0"
            for iid, kidx in zip(p.image_ids, p.point2D_idxs)
            if int(iid) in idx_of
        ]
        lines.append(f"{len(track)} " + " ".join(track))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    if list_path:
        with open(list_path, "w") as f:
            for iid in image_ids:
                f.write(images[iid].name + "\n")


def write_nvm(
    path: str,
    cameras: Dict[int, Camera],
    images: Dict[int, Image],
    points: Dict[int, Point3D],
):
    """Write a VisualSFM NVM_V3 model (camera centers + quaternions)."""
    image_ids = sorted(images)
    idx_of = {iid: i for i, iid in enumerate(image_ids)}
    lines = ["NVM_V3", "", str(len(image_ids))]
    for iid in image_ids:
        im = images[iid]
        cam = cameras[im.camera_id]
        R = qvec2rotmat(im.qvec)
        center = -R.T @ np.asarray(im.tvec)
        q = " ".join(f"{v:.10g}" for v in im.qvec)
        c = " ".join(f"{v:.10g}" for v in center)
        lines.append(f"{im.name} {_focal(cam):.10g} {q} {c} 0 0")
    lines += ["", str(len(points))]
    for p in points.values():
        xyz = " ".join(f"{v:.10g}" for v in p.xyz)
        rgb = " ".join(str(int(v)) for v in p.rgb)
        track = [
            f"{idx_of[int(iid)]} {int(kidx)} 0 0"
            for iid, kidx in zip(p.image_ids, p.point2D_idxs)
            if int(iid) in idx_of
        ]
        lines.append(f"{xyz} {rgb} {len(track)} " + " ".join(track))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def export_inlier_matches(
    db: COLMAPDatabase, path: str, min_num_matches: int = 15
):
    """Dump two-view-geometry inlier matches as
    ``name1 name2`` + ``idx1 idx2`` rows (export_inlier_matches.py)."""
    names = {iid: rec["name"] for iid, rec in db.read_images().items()}
    with open(path, "w") as f:
        for pair_id, rows, cols, data in db.execute(
            "SELECT pair_id, rows, cols, data FROM two_view_geometries"
        ):
            if data is None or rows < min_num_matches:
                continue
            id1, id2 = pair_id_to_image_ids(pair_id)
            matches = np.frombuffer(data, np.uint32).reshape(rows, cols)
            f.write(f"{names[id1]} {names[id2]} {rows}\n")
            for a, b in matches:
                f.write(f"{a} {b}\n")


def export_inlier_pairs(
    db: COLMAPDatabase, path: str, min_num_matches: int = 15
):
    """Dump verified image pairs, one ``name1 name2`` per line."""
    names = {iid: rec["name"] for iid, rec in db.read_images().items()}
    with open(path, "w") as f:
        for pair_id, rows in db.execute(
            "SELECT pair_id, rows FROM two_view_geometries WHERE data IS NOT NULL"
        ):
            if rows < min_num_matches:
                continue
            id1, id2 = pair_id_to_image_ids(pair_id)
            f.write(f"{names[id1]} {names[id2]}\n")


def merge_ply_files(inputs: List[str], output: str):
    """Concatenate binary-little-endian PLY vertex clouds
    (merge_ply_files.py). All inputs must share the same property layout."""
    headers, bodies = [], []
    for p in inputs:
        with open(p, "rb") as f:
            header = []
            while True:
                line = f.readline()
                header.append(line)
                if line.strip() == b"end_header":
                    break
            bodies.append(f.read())
            headers.append(header)

    def props(h):
        return [ln for ln in h if ln.startswith(b"property")]

    def n_verts(h):
        for ln in h:
            if ln.startswith(b"element vertex"):
                return int(ln.split()[-1])
        raise ValueError("no vertex element")

    if any(props(h) != props(headers[0]) for h in headers[1:]):
        raise ValueError("PLY property layouts differ; cannot merge")
    total = sum(n_verts(h) for h in headers)
    with open(output, "wb") as f:
        for ln in headers[0]:
            if ln.startswith(b"element vertex"):
                f.write(f"element vertex {total}\n".encode())
            else:
                f.write(ln)
        for b in bodies:
            f.write(b)
