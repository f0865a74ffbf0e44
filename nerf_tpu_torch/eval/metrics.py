"""Image quality metrics; counterpart of ``nerf_tpu/eval/metrics.py`` (MSE and
PSNR; SSIM comes with the evaluation slice)."""
from __future__ import annotations

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / m))
