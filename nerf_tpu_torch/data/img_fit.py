"""The img_fit dataset; counterpart of ``nerf_tpu/data/img_fit.py``.

One view's RGB as a function of uv: view ``view`` of
``<data_root>/<scene>/transforms_train.json``, read through the port's PNG
codec, composited onto white (``white_bkgd``) before it is resized by
``input_ratio`` (``blender.to_rgb``: bilinear with half-pixel centres, cv2's
INTER_LINEAR, exact at ratio 0.5), and the uv grid of the resized image,
u = linspace(0, 1, W) along a row and v = linspace(0, 1, H) down the
columns, flattened row-major as the image.
"""
from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from ..utils.png import inflate_png, unfilter
from .blender import to_rgb


class ImgFitDataset:
    """image [H, W, 3] float32; uv [H*W, 2] and rgb [H*W, 3] float32 on the host."""

    def __init__(self, data_root: str = "data/nerf_synthetic", scene: str = "lego",
                 split: str = "train", view: int = 0, input_ratio: float = 1.0,
                 n_pixels: int = 8192, white_bkgd: bool = True):
        self.split = split
        self.n_pixels = n_pixels
        scene_path = os.path.join(data_root, scene)
        with open(os.path.join(scene_path, "transforms_train.json")) as f:
            meta = json.load(f)
        frame = meta["frames"][view]
        with open(os.path.join(scene_path, frame["file_path"] + ".png"), "rb") as f:
            img = unfilter(*inflate_png(f.read()))  # [h, w, C] uint8
        H, W = img.shape[:2]
        if input_ratio != 1.0:
            H, W = int(H * input_ratio), int(W * input_ratio)
        self.image = to_rgb(img, H, W, white_bkgd)
        self.H, self.W = H, W
        u, v = np.meshgrid(np.linspace(0, 1, W, dtype=np.float32),
                           np.linspace(0, 1, H, dtype=np.float32))
        self.uv = np.stack([u, v], -1).reshape(-1, 2)
        self.rgb = self.image.reshape(-1, 3)

    def sample_batch(self, rng: np.random.RandomState) -> Dict[str, np.ndarray]:
        """``n_pixels`` pixels drawn uniformly with replacement from ``rng``."""
        idx = rng.randint(0, self.uv.shape[0], self.n_pixels)
        return {"uv": self.uv[idx], "rgb": self.rgb[idx]}

    def full(self) -> Dict[str, np.ndarray]:
        return {"uv": self.uv, "rgb": self.rgb, "H": self.H, "W": self.W}


def make_img_fit_dataset(cfg) -> ImgFitDataset:
    """The dataset of ``cfg.train_dataset``, which the JAX package's img_fit
    training and evaluation both read."""
    node = cfg.train_dataset
    return ImgFitDataset(data_root=node.data_root, scene=cfg.get("scene", "lego"),
                         view=int(node.get("view", 0)),
                         input_ratio=float(node.get("input_ratio", 1.0)),
                         n_pixels=int(node.get("N_pixels", 8192)))
