"""Compact COLMAP model I/O (cameras / images / points3D, .bin and .txt).

The port's copy of ``nerf_tpu/utils/colmap.py`` (numpy only). The reference
vendors the COLMAP toolbox (``src/utils/colmap/read_write_model.py``); this
is an implementation of the documented COLMAP sparse-model format covering
what the NeRF pipeline needs: reading and writing camera intrinsics, image
poses (qvec/tvec) and 3D points, dense depth/normal arrays, fused point
clouds, and quaternion/rotation helpers.
"""
from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, List

import numpy as np

# COLMAP camera model ids -> (name, #params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4), 3: ("RADIAL", 5),
    4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4), 9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}
CAMERA_MODEL_NPARAMS = {name: n for _, (name, n) in CAMERA_MODELS.items()}


@dataclass
class Camera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class Image:
    id: int
    qvec: np.ndarray  # [4] w,x,y,z world->cam rotation
    tvec: np.ndarray  # [3]
    camera_id: int
    name: str
    xys: np.ndarray = field(default_factory=lambda: np.zeros((0, 2)))
    point3D_ids: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int64))


@dataclass
class Point3D:
    id: int
    xyz: np.ndarray
    rgb: np.ndarray
    error: float
    image_ids: np.ndarray
    point2D_idxs: np.ndarray


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    K = np.array([
        [R[0, 0] - R[1, 1] - R[2, 2], 0, 0, 0],
        [R[0, 1] + R[1, 0], R[1, 1] - R[0, 0] - R[2, 2], 0, 0],
        [R[0, 2] + R[2, 0], R[1, 2] + R[2, 1], R[2, 2] - R[0, 0] - R[1, 1], 0],
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1],
         R[0, 0] + R[1, 1] + R[2, 2]],
    ]) / 3.0
    w, V = np.linalg.eigh(K)
    q = V[[3, 0, 1, 2], np.argmax(w)]
    return q * (1 if q[0] >= 0 else -1)


def image_c2w(img: Image) -> np.ndarray:
    """COLMAP stores world->cam; return the 4x4 camera-to-world matrix."""
    R = qvec2rotmat(img.qvec)
    t = img.tvec
    c2w = np.eye(4)
    c2w[:3, :3] = R.T
    c2w[:3, 3] = -R.T @ t
    return c2w


# ---------- binary I/O ----------

def _read(f, fmt):
    return struct.unpack(fmt, f.read(struct.calcsize(fmt)))


def read_cameras_bin(path: str) -> Dict[int, Camera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cid, mid, w, h = _read(f, "<iiQQ")
            name, np_ = CAMERA_MODELS[mid]
            params = np.array(_read(f, f"<{np_}d"))
            cams[cid] = Camera(cid, name, int(w), int(h), params)
    return cams


def read_images_bin(path: str) -> Dict[int, Image]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            iid = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (npts,) = _read(f, "<Q")
            data = np.frombuffer(
                f.read(24 * npts), dtype=[("xy", "<f8", 2), ("id", "<i8")]
            )
            imgs[iid] = Image(iid, qvec, tvec, cam_id, name.decode(),
                              data["xy"].copy(), data["id"].copy())
    return imgs


def read_points3d_bin(path: str) -> Dict[int, Point3D]:
    pts = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            pid = _read(f, "<Q")[0]
            xyz = np.array(_read(f, "<3d"))
            rgb = np.array(_read(f, "<3B"))
            (err,) = _read(f, "<d")
            (tl,) = _read(f, "<Q")
            track = np.frombuffer(f.read(8 * tl), dtype="<i4").reshape(-1, 2)
            pts[pid] = Point3D(pid, xyz, rgb, err, track[:, 0].copy(),
                               track[:, 1].copy())
    return pts


def write_cameras_bin(path: str, cams: Dict[int, Camera]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            mid = CAMERA_MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack(f"<{len(c.params)}d", *c.params))


def write_images_bin(path: str, imgs: Dict[int, Image]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode() + b"\x00")
            f.write(struct.pack("<Q", len(im.xys)))
            for xy, pid in zip(im.xys, im.point3D_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def write_points3d_bin(path: str, pts: Dict[int, Point3D]):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(pts)))
        for p in pts.values():
            f.write(struct.pack("<Q", p.id))
            f.write(struct.pack("<3d", *p.xyz))
            f.write(struct.pack("<3B", *p.rgb.astype(np.uint8)))
            f.write(struct.pack("<d", p.error))
            f.write(struct.pack("<Q", len(p.image_ids)))
            for iid, pidx in zip(p.image_ids, p.point2D_idxs):
                f.write(struct.pack("<ii", int(iid), int(pidx)))


# ---------- text I/O ----------

def read_cameras_txt(path: str) -> Dict[int, Camera]:
    cams = {}
    for line in open(path):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        cid, model, w, h = int(parts[0]), parts[1], int(parts[2]), int(parts[3])
        cams[cid] = Camera(cid, model, w, h, np.array([float(x) for x in parts[4:]]))
    return cams


def read_images_txt(path: str) -> Dict[int, Image]:
    imgs = {}
    # keep empty lines: an image with zero 2D points has an EMPTY points
    # line, and dropping it would shift the header/points pairing
    lines = [l.rstrip("\n") for l in open(path) if not l.startswith("#")]
    while lines and not lines[-1].strip():
        lines.pop()
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        iid = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        cam_id, name = int(parts[8]), parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array([[float(pts[j]), float(pts[j + 1])]
                        for j in range(0, len(pts), 3)])
        ids = np.array([int(pts[j + 2]) for j in range(0, len(pts), 3)],
                       np.int64)
        imgs[iid] = Image(iid, qvec, tvec, cam_id, name, xys, ids)
    return imgs


def write_cameras_txt(path: str, cams: Dict[int, Camera]):
    with open(path, "w") as f:
        f.write("# Camera list: CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for c in cams.values():
            params = " ".join(repr(float(p)) for p in c.params)
            f.write(f"{c.id} {c.model} {c.width} {c.height} {params}\n")


def write_images_txt(path: str, imgs: Dict[int, Image]):
    with open(path, "w") as f:
        f.write("# Image list: IMAGE_ID, QW QX QY QZ, TX TY TZ, CAMERA_ID, NAME\n")
        for im in imgs.values():
            q = " ".join(repr(float(x)) for x in im.qvec)
            t = " ".join(repr(float(x)) for x in im.tvec)
            f.write(f"{im.id} {q} {t} {im.camera_id} {im.name}\n")
            pts = " ".join(
                f"{x} {y} {int(pid)}"
                for (x, y), pid in zip(im.xys, im.point3D_ids)
            )
            f.write(pts + "\n")


def read_model(model_dir: str):
    """Auto-detect .bin/.txt model -> (cameras, images, points3D|None)."""
    if os.path.exists(os.path.join(model_dir, "cameras.bin")):
        cams = read_cameras_bin(os.path.join(model_dir, "cameras.bin"))
        imgs = read_images_bin(os.path.join(model_dir, "images.bin"))
        p3d_path = os.path.join(model_dir, "points3D.bin")
        pts = read_points3d_bin(p3d_path) if os.path.exists(p3d_path) else None
    else:
        cams = read_cameras_txt(os.path.join(model_dir, "cameras.txt"))
        imgs = read_images_txt(os.path.join(model_dir, "images.txt"))
        p3d_path = os.path.join(model_dir, "points3D.txt")
        pts = read_points3d_txt(p3d_path) if os.path.exists(p3d_path) else None
    return cams, imgs, pts


# ---------------------------------------------------------------------------
# points3D txt I/O (rounds out the txt model surface of read_write_model.py)

def read_points3d_txt(path: str) -> Dict[int, Point3D]:
    pts: Dict[int, Point3D] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            track = np.asarray(e[8:], float).reshape(-1, 2)
            pts[int(e[0])] = Point3D(
                id=int(e[0]),
                xyz=np.asarray(e[1:4], np.float64),
                rgb=np.asarray(e[4:7], np.uint8),
                error=float(e[7]),
                image_ids=track[:, 0].astype(np.int64),
                point2D_idxs=track[:, 1].astype(np.int64),
            )
    return pts


def write_points3d_txt(path: str, pts: Dict[int, Point3D]):
    with open(path, "w") as f:
        f.write("# 3D point list: POINT3D_ID X Y Z R G B ERROR "
                "TRACK[] as (IMAGE_ID POINT2D_IDX)\n")
        for p in pts.values():
            track = " ".join(
                f"{int(i)} {int(j)}"
                for i, j in zip(p.image_ids, p.point2D_idxs))
            xyz = " ".join(f"{v:.12g}" for v in p.xyz)
            rgb = " ".join(str(int(v)) for v in p.rgb)
            f.write(f"{p.id} {xyz} {rgb} {p.error:.12g} {track}\n")


# ---------------------------------------------------------------------------
# dense workspace I/O (COLMAP read_write_dense.py surface): depth / normal
# maps are stored as an ASCII "W&H&C&" header followed by float32 data laid
# out so that reshape((W,H,C), order="F").transpose(1,0,2) yields [H,W,C].

def read_array(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = b""
        while header.count(b"&") < 3:
            c = f.read(1)
            if not c:
                raise ValueError(f"truncated dense-map header in {path}")
            header += c
        w, h, ch = (int(x) for x in header.decode().split("&")[:3])
        data = np.fromfile(f, np.float32)
    if data.size != w * h * ch:
        raise ValueError(
            f"{path}: expected {w * h * ch} floats, got {data.size}")
    arr = data.reshape((w, h, ch), order="F")
    return np.transpose(arr, (1, 0, 2)).squeeze()


def write_array(path: str, array: np.ndarray):
    arr = np.asarray(array, np.float32)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, ch = arr.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{ch}&".encode())
        # invert read_array: data reshaped (W,H,C) order="F" then transposed
        # to [H,W,C] -> store the [W,H,C] transpose flattened in F order
        np.transpose(arr, (1, 0, 2)).reshape(-1, order="F").astype(
            np.float32).tofile(f)


# ---------------------------------------------------------------------------
# fused point cloud I/O (COLMAP read_write_fused_vis.py surface):
# fused.ply = binary little-endian PLY (x y z nx ny nz r g b), fused.ply.vis
# = uint64 count then per point uint32 n + n uint32 source-image indices.

@dataclass
class MeshPoint:
    position: np.ndarray      # [3] float32
    normal: np.ndarray        # [3] float32
    color: np.ndarray         # [3] uint8
    visible_image_idxs: np.ndarray  # [n] uint32


def write_fused(points: List[MeshPoint], ply_path: str, vis_path: str):
    with open(ply_path, "wb") as f:
        f.write(
            b"ply\nformat binary_little_endian 1.0\n"
            + f"element vertex {len(points)}\n".encode()
            + b"property float x\nproperty float y\nproperty float z\n"
            b"property float nx\nproperty float ny\nproperty float nz\n"
            b"property uchar red\nproperty uchar green\nproperty uchar blue\n"
            b"end_header\n")
        for p in points:
            f.write(struct.pack("<6f", *np.asarray(p.position, np.float32),
                                *np.asarray(p.normal, np.float32)))
            f.write(struct.pack("<3B", *np.asarray(p.color, np.uint8)))
    with open(vis_path, "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points:
            idxs = np.asarray(p.visible_image_idxs, np.uint32)
            f.write(struct.pack("<I", idxs.size))
            f.write(idxs.tobytes())


def read_fused(ply_path: str, vis_path: str) -> List[MeshPoint]:
    with open(ply_path, "rb") as f:
        n_vertex = 0
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n_vertex = int(line.split()[-1])
            if line == b"end_header":
                break
        rec = np.dtype([("xyz", "<f4", 3), ("normal", "<f4", 3),
                        ("rgb", "u1", 3)])
        verts = np.frombuffer(f.read(rec.itemsize * n_vertex), rec)
    points = []
    with open(vis_path, "rb") as f:
        (n_vis,) = struct.unpack("<Q", f.read(8))
        if n_vis != n_vertex:
            raise ValueError(
                f"vis file has {n_vis} entries for {n_vertex} vertices")
        for i in range(n_vertex):
            (n,) = struct.unpack("<I", f.read(4))
            idxs = np.frombuffer(f.read(4 * n), np.uint32)
            points.append(MeshPoint(
                position=verts["xyz"][i].copy(),
                normal=verts["normal"][i].copy(),
                color=verts["rgb"][i].copy(),
                visible_image_idxs=idxs.copy(),
            ))
    return points
