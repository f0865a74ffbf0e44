"""Conversion of black-background ground truth to white; counterpart of
``nerf_tpu/eval/background.py`` (``background_strategy``: "conservative",
"smart" or "none"; the lego config ships "none").

The JAX package floods from each dark border pixel with ``cv2.floodFill``
(4-connected) and takes local variance with ``cv2.blur`` (5x5,
BORDER_REFLECT_101). Here the border-connected components come from
``scipy.ndimage.label`` with its default cross structure (4-connected), and
the box filter is ``scipy.ndimage.uniform_filter(size=5, mode="mirror")``,
scipy's name for reflect-101.
"""
from __future__ import annotations

import numpy as np


def _flood_background_mask(dark: np.ndarray) -> np.ndarray:
    """The 4-connected components of ``dark`` that touch the image border."""
    from scipy.ndimage import label

    labels, _ = label(dark)
    border = np.concatenate([labels[0], labels[-1], labels[:, 0], labels[:, -1]])
    keep = np.unique(border[border > 0])
    return np.isin(labels, keep)


def conservative_background_conversion(img: np.ndarray,
                                       dark_threshold: float = 0.1) -> np.ndarray:
    """[H, W, 3] float in [0, 1]: dark components touching the border become
    white; dark parts inside the object stay."""
    img = np.asarray(img, np.float32)
    dark = img.max(axis=-1) < dark_threshold
    if not dark.any():
        return img
    out = img.copy()
    out[_flood_background_mask(dark)] = 1.0
    return out


def smart_background_conversion(img: np.ndarray, dark_threshold: float = 0.12,
                                var_threshold: float = 1e-4,
                                sat_threshold: float = 0.15) -> np.ndarray:
    """A pixel is background if it is dark, locally flat, unsaturated and
    border-connected."""
    from scipy.ndimage import uniform_filter

    img = np.asarray(img, np.float32)
    gray = img.mean(axis=-1)
    dark = gray < dark_threshold
    mean = uniform_filter(gray, size=5, mode="mirror")
    mean_sq = uniform_filter(gray * gray, size=5, mode="mirror")
    flat = np.maximum(mean_sq - mean * mean, 0.0) < var_threshold
    mx, mn = img.max(axis=-1), img.min(axis=-1)
    sat = np.where(mx > 1e-6, (mx - mn) / np.maximum(mx, 1e-6), 0.0)
    candidate = dark & flat & (sat < sat_threshold)
    if not candidate.any():
        return img
    out = img.copy()
    out[_flood_background_mask(candidate)] = 1.0
    return out


def convert_background(img: np.ndarray, strategy: str = "none") -> np.ndarray:
    if strategy == "conservative":
        return conservative_background_conversion(img)
    if strategy == "smart":
        return smart_background_conversion(img)
    return np.asarray(img, np.float32)
