"""Blender synthetic (nerf_synthetic) scenes; counterpart of ``nerf_tpu/data/blender.py``.

Reads ``<data_root>/<scene>/transforms_<split>.json`` and its PNG frames with
the port's own decoder (``utils/png.py``; the card's machine has neither
imageio nor cv2): a thread pool reads and inflates the files, then each
frame is unfiltered in turn (numpy steps driven from Python: on an H100's
host, eight threads doing all of it read 800x800 RGBA frames at 1.94 a
second, one thread decodes 8.41). focal = 0.5 W /
tan(0.5 camera_angle_x); RGBA frames are composited onto white as
rgb * a + (1 - a) when ``white_bkgd``; ``input_ratio`` scales (H, W) and
``cams`` = (start, stop, step) slices the frames, as the JAX package applies
them; frames whose file is missing are skipped. A frame of another size is
resized bilinearly (``F.interpolate``, half-pixel centres, no antialias), as
the JAX package's native loader and cv2's INTER_LINEAR at ratio 0.5 do.
"""
from __future__ import annotations

import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.png import encode_png, inflate_png, unfilter


def _inflate_file(path: str):
    with open(path, "rb") as f:
        return inflate_png(f.read())


def to_rgb(img: np.ndarray, H: int, W: int, white_bkgd: bool) -> np.ndarray:
    """A decoded frame [h, w, C] uint8 -> [H, W, 3] float32 in [0, 1]."""
    img = img.astype(np.float32) / 255.0
    if img.shape[-1] in (2, 4):  # with alpha
        rgb, alpha = img[..., :-1], img[..., -1:]
        img = rgb * alpha + (1.0 - alpha) if white_bkgd else rgb
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    if img.shape[:2] != (H, W):
        img = resize_bilinear(img, H, W)
    return np.ascontiguousarray(img, np.float32)


def resize_bilinear(img: np.ndarray, H: int, W: int) -> np.ndarray:
    """[h, w, C] float32 -> [H, W, C]: bilinear, half-pixel centres, edges
    clamped, no antialias (cv2's INTER_LINEAR; at ratio 0.5 the mean of each
    2x2 block, as cv2's INTER_AREA that it switches to there)."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32)).permute(2, 0, 1)[None]
    t = F.interpolate(t, size=(H, W), mode="bilinear", align_corners=False, antialias=False)
    return t[0].permute(1, 2, 0).numpy()


class BlenderDataset:
    """One split of a Blender synthetic scene: images [N, H, W, 3] float32 on
    the host, poses [N, 4, 4] float32, K [3, 3] float32, H, W, focal."""

    def __init__(self, data_root: str = "data/nerf_synthetic", split: str = "train",
                 scene: str = "lego", input_ratio: float = 1.0,
                 cams: Optional[Sequence[int]] = None, H: int = 800, W: int = 800,
                 white_bkgd: bool = True):
        self.split = split
        scene_path = os.path.join(data_root, scene)
        with open(os.path.join(scene_path, f"transforms_{split}.json")) as f:
            meta = json.load(f)
        if input_ratio != 1.0:
            H, W = int(H * input_ratio), int(W * input_ratio)
        self.H, self.W = H, W
        self.focal = (0.5 * W / np.tan(0.5 * meta["camera_angle_x"])
                      if "camera_angle_x" in meta else float(W))

        frames = meta["frames"]
        if cams is not None and tuple(cams) != (0, -1, 1):
            start, stop, step = cams
            frames = frames[start:None if stop == -1 else stop:step]
        paths, poses = [], []
        for frame in frames:
            path = os.path.join(scene_path, frame["file_path"] + ".png")
            if not os.path.exists(path):
                continue
            paths.append(path)
            poses.append(np.asarray(frame["transform_matrix"], dtype=np.float32))

        with ThreadPoolExecutor(max(1, min(len(paths), os.cpu_count() or 1))) as pool:
            images = [to_rgb(unfilter(*inflated), H, W, white_bkgd)
                      for inflated in pool.map(_inflate_file, paths)]
        self.images = np.stack(images) if images else np.zeros((0, H, W, 3), np.float32)
        self.poses = np.stack(poses) if poses else np.zeros((0, 4, 4), np.float32)
        self.K = np.array([[self.focal, 0, W / 2], [0, self.focal, H / 2], [0, 0, 1]],
                          dtype=np.float32)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int) -> Dict:
        return {"index": index, "image": self.images[index], "pose": self.poses[index],
                "intrinsics": self.K, "H": self.H, "W": self.W}


def make_blender_dataset(cfg, split: str) -> BlenderDataset:
    node = cfg.train_dataset if split == "train" else cfg.test_dataset
    return BlenderDataset(data_root=node.data_root, split=node.get("split", split),
                          scene=cfg.get("scene", "lego"),
                          input_ratio=float(node.get("input_ratio", 1.0)),
                          cams=node.get("cams", None), H=int(node.get("H", 800)),
                          W=int(node.get("W", 800)), white_bkgd=bool(cfg.task_arg.white_bkgd))


def write_blender_scene(scene_dir: str, splits: Dict[str, tuple], camera_angle_x: float,
                        filters=0) -> None:
    """Write a Blender-layout scene: for each split name -> (images [N, H, W, C]
    uint8, poses [N, 4, 4]), ``<split>/r_<i>.png`` and
    ``transforms_<split>.json`` with ``camera_angle_x``. ``filters``: the PNG
    row filters (``utils.png.encode_png``)."""
    for split, (images, poses) in splits.items():
        os.makedirs(os.path.join(scene_dir, split), exist_ok=True)
        frames = []
        for i, (img, pose) in enumerate(zip(images, poses)):
            with open(os.path.join(scene_dir, split, f"r_{i}.png"), "wb") as f:
                f.write(encode_png(np.asarray(img), filters))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": np.asarray(pose, np.float64).tolist()})
        with open(os.path.join(scene_dir, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": camera_angle_x, "frames": frames}, f, indent=1)
