"""The ZJU light-stage multi-camera dataset; counterpart of ``nerf_tpu/data/light_stage.py``.

An ``annots.npy`` rig ({cams: {K, R, T, D}, ims: per-frame image lists}),
per-frame vertices whose boxes make the world bound, foreground masks,
camera and frame ranges ``[start, end, skip]``, and ray batches that mix
foreground (mask) and background (the world bound's screen box) pixels for
training, the whole image for testing. A ray is [origin 3, unit direction
3, the frame's latent index]; host-side numpy, as in the JAX package.

Without cv2 or imageio: images and masks are read through the port's PNG
codec (``utils/png.py``; the JAX package reads any format imageio reads),
undistorted by ``utils/remap.undistort`` (cv2.undistort's map and bilinear
arithmetic, the mask's in cv2's 15-bit integers), and resized by
``input_ratio`` bilinearly (``blender.resize_bilinear``; cv2's INTER_LINEAR,
its INTER_AREA at 0.5) and the mask by ``remap.resize_nearest``. The
foreground and background pixels are drawn from ``np.random.RandomState
(seed)`` in the JAX loader's order, so both loaders pick the same pixels.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.png import read_png, write_png
from ..utils.remap import resize_nearest, undistort
from ..utils.vis_utils import get_bbox_2d, get_bound_2d_mask
from .blender import resize_bilinear


def _undistort(img: np.ndarray, K: np.ndarray, D: Optional[np.ndarray]) -> np.ndarray:
    if D is None or not np.any(np.abs(D) > 1e-12):
        return img
    return undistort(img, K, D)


def project_bbox(wbbox: np.ndarray, K: np.ndarray, ext: np.ndarray, H: int,
                 W: int) -> Tuple[np.ndarray, np.ndarray]:
    """The 8 world-bound corners projected -> (their screen box [x0, y0, x1,
    y1] clipped to the image, its HxW mask): the background rays' region."""
    bounds = np.asarray(wbbox, np.float64).reshape(2, 3)
    bb = get_bbox_2d(bounds, K, ext)
    x0, y0 = max(int(np.floor(bb[0])), 0), max(int(np.floor(bb[1])), 0)
    x1, y1 = min(int(np.ceil(bb[2])), W - 1), min(int(np.ceil(bb[3])), H - 1)
    return np.array([x0, y0, x1, y1]), get_bound_2d_mask(bounds, K, ext, H, W)


class LightStageDataset:
    def __init__(self, data_root: str, split: str = "train",
                 cameras: Tuple[int, int, int] = (0, -1, 1),
                 frames: Tuple[int, int, int] = (0, -1, 1),
                 train_frames: Optional[Tuple[int, int, int]] = None,
                 input_ratio: float = 1.0, n_rays: int = 1024,
                 vertices_dir: str = "new_vertices", seed: int = 0):
        self.data_root = data_root
        self.split = split
        self.input_ratio = float(input_ratio)
        self.n_rays = int(n_rays)
        self._rng = np.random.RandomState(seed)

        annots = np.load(os.path.join(data_root, "annots.npy"), allow_pickle=True).item()
        self.cams = annots["cams"]
        num_cams = len(self.cams["K"])
        c0, c1, cs = cameras
        self.render_cameras = np.arange(num_cams)[c0:num_cams if c1 == -1 else c1:cs]

        num_frames = len(annots["ims"])
        f0, f1, fs = frames
        t0, t1, ts = train_frames if train_frames is not None else frames
        training_frames = np.arange(num_frames)[t0:num_frames if t1 == -1 else t1:ts].tolist()

        self.items: List[Dict] = []
        bboxs = []
        for fi in np.arange(num_frames)[f0:num_frames if f1 == -1 else f1:fs]:
            # the latent index: the frame's position in the training schedule
            latent = training_frames.index(fi) if fi in training_frames else 0
            for ci in self.render_cameras:
                self.items.append(dict(img_path=os.path.join(data_root, annots["ims"][fi]["ims"][ci]),
                                       frame_index=int(fi), camera_index=int(ci),
                                       latent_index=int(latent)))
            verts = np.load(os.path.join(data_root, vertices_dir, f"{fi}.npy"))
            bboxs.append(np.concatenate([verts.min(0) - 0.05, verts.max(0) + 0.05]))
        bboxs = np.stack(bboxs)
        self.wbbox = np.concatenate([bboxs[:, :3].min(0), bboxs[:, 3:6].max(0)]).astype(np.float32)
        self._cache: Dict[int, Tuple] = {}
        self._region_cache: Dict[int, Tuple] = {}

    def __len__(self) -> int:
        return len(self.items)

    def _mask_path(self, img_path: str) -> str:
        rel = os.path.relpath(img_path, self.data_root)
        for cand in (os.path.join(self.data_root, "mask_cihp", rel),
                     os.path.join(self.data_root, "mask", rel),
                     os.path.join(self.data_root, rel.replace("images", "mask"))):
            p = os.path.splitext(cand)[0] + ".png"
            if os.path.exists(p):
                return p
        raise FileNotFoundError(f"no mask for {img_path}")

    def _read(self, index: int):
        """(image [H, W, 3] float32 with the background black, mask [H, W]
        uint8 0/1, K, extrinsics [4, 4], foreground box), cached."""
        if index in self._cache:
            return self._cache[index]
        item = self.items[index]
        img = read_png(item["img_path"]).astype(np.float32) / 255.0
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, -1)
        img = np.ascontiguousarray(img[..., :3])
        msk = read_png(self._mask_path(item["img_path"]))
        if msk.ndim == 3:
            msk = msk[..., 0]
        msk = (msk != 0).astype(np.uint8)

        ci = item["camera_index"]
        K = np.asarray(self.cams["K"][ci], np.float64).copy()
        D_list = self.cams.get("D")
        D = np.asarray(D_list[ci], np.float64) if D_list is not None else np.zeros(5)
        img = _undistort(img, K, D)
        msk = _undistort(msk, K, D)

        if self.input_ratio != 1.0:
            H, W = img.shape[:2]
            img = resize_bilinear(img, int(np.rint(H * self.input_ratio)),
                                  int(np.rint(W * self.input_ratio)))
            msk = resize_nearest(msk, self.input_ratio)
            K[:2] *= self.input_ratio

        img = img * (msk > 0)[..., None]  # the background black
        nz = msk.nonzero()
        fg_bbox = (np.array([nz[1].min() - 1, nz[0].min() - 1, nz[1].max() + 1, nz[0].max() + 1])
                   if nz[0].size else np.array([0, 0, msk.shape[1] - 1, msk.shape[0] - 1]))

        R = np.asarray(self.cams["R"][ci], np.float64)
        T = np.asarray(self.cams["T"][ci], np.float64).reshape(3) / 1000.0
        ext = np.eye(4)
        ext[:3, :3], ext[:3, 3] = R, T
        out = (img.astype(np.float32), msk, K.astype(np.float32), ext.astype(np.float32), fg_bbox)
        self._cache[index] = out
        return out

    def _sample_region(self, bbox, region_mask, count, H, W, oversample=4):
        x = self._rng.randint(max(int(bbox[0]), 0), min(int(bbox[2]) + 1, W),
                              size=oversample * count)
        y = self._rng.randint(max(int(bbox[1]), 0), min(int(bbox[3]) + 1, H),
                              size=oversample * count)
        ok = region_mask[y, x] == 1
        return x[ok][:count], y[ok][:count]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        item = self.items[index]
        img, msk, K, ext, fg_bbox = self._read(index)
        H, W = img.shape[:2]
        if self.split == "train":
            fg_num = self.n_rays // 2
            px_f, py_f = self._sample_region(fg_bbox, msk, fg_num, H, W)
            ci = item["camera_index"]
            if ci not in self._region_cache:  # the world bound's screen box, fixed a camera
                self._region_cache[ci] = project_bbox(self.wbbox, K, ext, H, W)
            bb2d, region = self._region_cache[ci]
            px_b, py_b = self._sample_region(bb2d, region, self.n_rays - fg_num, H, W)
            px, py = np.concatenate([px_f, px_b]), np.concatenate([py_f, py_b])
            rgb = img[py, px]
        else:
            px, py = np.meshgrid(np.arange(W), np.arange(H))
            px, py = px.reshape(-1), py.reshape(-1)
            rgb = img.reshape(-1, 3)

        c2w = np.linalg.inv(ext)
        rays_o = np.broadcast_to(c2w[:3, 3], (len(px), 3))
        d = np.stack([px, py, np.ones_like(px)], -1).astype(np.float64)
        d = d @ np.linalg.inv(K).T @ c2w[:3, :3].T
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        rays_t = np.full((len(px), 1), item["latent_index"], np.float64)
        rays = np.concatenate([rays_o, d, rays_t], -1).astype(np.float32)
        return {"rays": rays, "rgb": rgb.astype(np.float32), "wbounds": self.wbbox,
                "meta": {"H": H, "W": W, "item": item}}


def write_light_stage_rig(root: str, cams: Dict[str, list], images, masks, vertices) -> None:
    """Write a rig in the layout the loader reads: ``annots.npy`` with
    ``cams`` ({K, R, T (millimetres), D}: a list each, one entry a camera) and
    ``ims``; ``images/camCC/FFFF.png`` and ``mask/images/camCC/FFFF.png``
    (``images[f][c]`` [H, W, 3] uint8, ``masks[f][c]`` [H, W] uint8, 0 the
    background); ``new_vertices/<f>.npy`` (``vertices[f]`` [V, 3])."""
    ims = []
    for f, (frame_imgs, frame_msks) in enumerate(zip(images, masks)):
        rels = []
        for c, (img, msk) in enumerate(zip(frame_imgs, frame_msks)):
            rel = os.path.join("images", f"cam{c:02d}", f"{f:04d}.png")
            for sub, arr in (("", img), ("mask", msk)):
                path = os.path.join(root, sub, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                write_png(path, np.asarray(arr, np.uint8))
            rels.append(rel)
        ims.append({"ims": rels})
        os.makedirs(os.path.join(root, "new_vertices"), exist_ok=True)
        np.save(os.path.join(root, "new_vertices", f"{f}.npy"), np.asarray(vertices[f]))
    np.save(os.path.join(root, "annots.npy"), {"cams": cams, "ims": ims}, allow_pickle=True)


def write_synthetic_rig(root: str, n_cams: int = 4, n_frames: int = 2, H: int = 64, W: int = 80,
                        seed: int = 0, distortion=(-0.3, 0.1, 2e-3, -2e-3, -0.02)) -> None:
    """A rig made from ``seed``: ``n_cams`` cameras on a ring 2 m round the
    origin (focal 0.7 W, principal point off centre, the same
    ``distortion`` for all), images of noise over a ramp, elliptic
    foreground masks, 50 vertices in [-0.5, 0.5]^3 a frame."""
    rng = np.random.default_rng(seed)
    cams = {"K": [], "R": [], "T": [], "D": []}
    for c in range(n_cams):
        th = 2 * np.pi * c / n_cams
        cams["K"].append(np.array([[0.7 * W, 0, W / 2 + 1.5], [0, 0.7 * W, H / 2 - 0.75],
                                   [0, 0, 1]]))
        cams["R"].append(np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                                   [-np.sin(th), 0, np.cos(th)]]))
        cams["T"].append(np.array([[0.0], [0.0], [2000.0]]))
        cams["D"].append(np.asarray(distortion, np.float64))
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    ramp = np.stack([xx / W, yy / H, 0.5 * (xx / W + yy / H)], -1)
    images, masks = [], []
    for _ in range(n_frames):
        images.append([np.clip((ramp + rng.uniform(-0.2, 0.2, ramp.shape)) * 255, 0, 255)
                       .astype(np.uint8) for _ in range(n_cams)])
        frame_masks = []
        for _ in range(n_cams):
            cx, cy = W / 2 + rng.uniform(-W / 10, W / 10), H / 2 + rng.uniform(-H / 10, H / 10)
            inside = ((xx - cx) / (W / 4)) ** 2 + ((yy - cy) / (H / 3)) ** 2 <= 1.0
            frame_masks.append(np.where(inside, 255, 0).astype(np.uint8))
        masks.append(frame_masks)
    vertices = [rng.uniform(-0.5, 0.5, (50, 3)).astype(np.float32) for _ in range(n_frames)]
    write_light_stage_rig(root, cams, images, masks, vertices)
