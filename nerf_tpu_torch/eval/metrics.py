"""Image quality metrics; counterpart of ``nerf_tpu/eval/metrics.py``: MSE,
PSNR and SSIM, in numpy float64 on the host, as the JAX evaluator computes
them.

SSIM follows skimage's ``structural_similarity`` defaults as the JAX
package's does: a 7x7 uniform window (``scipy.ndimage.uniform_filter``,
mode "reflect"), K1 = 0.01, K2 = 0.03, data_range 1, the sample covariance
(N / (N - 1)), the mean over the valid interior, averaged over channels.
"""
from __future__ import annotations

import numpy as np


def mse(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    m = mse(a, b)
    if m == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / m))


def ssim_single(a: np.ndarray, b: np.ndarray, win_size: int = 7,
                data_range: float = 1.0) -> float:
    """SSIM of one 2D channel."""
    from scipy.ndimage import uniform_filter

    def box(x):
        return uniform_filter(x, size=win_size, mode="reflect")

    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    cov_norm = win_size ** 2 / (win_size ** 2 - 1)
    ux, uy = box(a), box(b)
    vx = cov_norm * (box(a * a) - ux * ux)
    vy = cov_norm * (box(b * b) - uy * uy)
    vxy = cov_norm * (box(a * b) - ux * uy)
    s = ((2 * ux * uy + c1) * (2 * vxy + c2)) / ((ux ** 2 + uy ** 2 + c1) * (vx + vy + c2))
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def ssim(a: np.ndarray, b: np.ndarray, win_size: int = 7, data_range: float = 1.0) -> float:
    """SSIM of [H, W] or [H, W, C] images: the mean over the channels."""
    a, b = np.asarray(a), np.asarray(b)
    if a.ndim == 2:
        return ssim_single(a, b, win_size, data_range)
    return float(np.mean([ssim_single(a[..., c], b[..., c], win_size, data_range)
                          for c in range(a.shape[-1])]))
