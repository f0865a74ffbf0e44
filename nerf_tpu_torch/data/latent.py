"""The latent-vector regression dataset; counterpart of ``nerf_tpu/data/latent.py``.

``<data_root>/<scene>.npy`` holds rows of concatenated features, split into
x1 [:1] (a scalar index), x2 [1:32] (a 31-d conditioning code), y1 [32:160]
and y2 [160:] (two latent targets).
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np


class LatentDataset:
    X1, X2, Y1 = 1, 32, 32 + 128  # the column split points

    def __init__(self, data_root: str, scene: str, batch_size: int = 1024):
        self.data = np.load(os.path.join(data_root, f"{scene}.npy"))
        if self.data.ndim != 2 or self.data.shape[1] <= self.Y1:
            raise ValueError(f"latent data must be [N, >{self.Y1}], got {self.data.shape}")
        self.batch_size = int(batch_size)

    def __len__(self) -> int:
        return len(self.data)

    def split(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        d = self.data
        return d[:, :self.X1], d[:, self.X1:self.X2], d[:, self.X2:self.Y1], d[:, self.Y1:]

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        """Every row, split (the JAX package's item ignores ``index`` too)."""
        x1, x2, y1, y2 = self.split()
        return {"x1": x1, "x2": x2, "y1": y1, "y2": y2}
