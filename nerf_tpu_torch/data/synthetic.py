"""In-memory synthetic scene; counterpart of ``nerf_tpu/data/synthetic.py``.

Random images from a seeded ``numpy.random.RandomState`` and cameras on a
horizontal orbit of radius 4 looking at the origin, the same arrays as the
JAX package's ``SyntheticDataset`` for the same arguments.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def _orbit_pose(theta: float, radius: float = 4.0) -> np.ndarray:
    """Camera on a horizontal orbit looking at the origin (OpenGL convention:
    -z forward, as the Blender transforms)."""
    eye = np.asarray([radius * np.sin(theta), 0.0, radius * np.cos(theta)], np.float32)
    forward = -eye / np.linalg.norm(eye)
    up = np.asarray([0.0, 1.0, 0.0], np.float32)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    true_up = np.cross(right, forward)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0] = right
    pose[:3, 1] = true_up
    pose[:3, 2] = -forward
    pose[:3, 3] = eye
    return pose


class SyntheticDataset:
    """images [N, H, W, 3] float32 in [0, 1], poses [N, 4, 4], K [3, 3], H, W."""

    def __init__(self, split: str = "train", n_images: int = 2, H: int = 16, W: int = 16,
                 seed: int = 0):
        self.split = split
        self.H, self.W = H, W
        rng = np.random.RandomState(seed + {"train": 0, "val": 1, "test": 2}.get(split, 3))
        self.images = rng.rand(n_images, H, W, 3).astype(np.float32)
        self.poses = np.stack([_orbit_pose(2 * np.pi * i / max(n_images, 1))
                               for i in range(n_images)])
        self.focal = float(W)
        self.K = np.array([[self.focal, 0, W / 2], [0, self.focal, H / 2], [0, 0, 1]],
                          dtype=np.float32)

    def __len__(self) -> int:
        return len(self.images)

    def __getitem__(self, index: int) -> Dict:
        return {"index": index, "image": self.images[index], "pose": self.poses[index],
                "intrinsics": self.K, "H": self.H, "W": self.W}


def make_synthetic_dataset(cfg, split: str) -> SyntheticDataset:
    node = cfg.train_dataset if split == "train" else cfg.test_dataset
    return SyntheticDataset(split=node.get("split", split), n_images=int(node.get("n_images", 2)),
                            H=int(node.get("H", 16)), W=int(node.get("W", 16)),
                            seed=int(cfg.get("seed", 0)))
