"""Bound projection helpers; counterpart of ``nerf_tpu/utils/vis_utils.py``.

The 8 corners of a 3D bound, their projection through a camera, the
screen-space box of the projection and its HxW mask (the light-stage
sampler's background region), and the imagenet normalisation constants.
"""
from __future__ import annotations

import numpy as np

# imagenet normalisation
mean_rgb = np.array([0.485, 0.456, 0.406], np.float32).reshape(1, 1, 3)
std_rgb = np.array([0.229, 0.224, 0.225], np.float32).reshape(1, 1, 3)


def get_bound_corners(bounds: np.ndarray) -> np.ndarray:
    """bounds [2, 3] (min, max) -> the 8 corners [8, 3], z fastest."""
    lo, hi = bounds[0], bounds[1]
    return np.array([[x, y, z] for x in (lo[0], hi[0]) for y in (lo[1], hi[1])
                     for z in (lo[2], hi[2])])


def project(xyz: np.ndarray, K: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """World points [N, 3] -> pixel coordinates [N, 2] through the extrinsics
    RT [3 or 4, 4] and the intrinsics K."""
    cam = xyz @ RT[:3, :3].T + RT[:3, 3]
    uv = cam @ np.asarray(K).T
    return uv[:, :2] / np.maximum(uv[:, 2:], 1e-8)


def get_bbox_2d(bounds: np.ndarray, K: np.ndarray, RT: np.ndarray) -> np.ndarray:
    """[x0, y0, x1, y1], the screen-space box of the projected bounds."""
    uv = project(get_bound_corners(np.asarray(bounds).reshape(2, 3)), K, RT)
    return np.array([uv[:, 0].min(), uv[:, 1].min(), uv[:, 0].max(), uv[:, 1].max()])


def get_bound_2d_mask(bounds: np.ndarray, K: np.ndarray, RT: np.ndarray, H: int,
                      W: int) -> np.ndarray:
    """HxW uint8 mask of the pixels inside that box."""
    x0, y0, x1, y1 = get_bbox_2d(bounds, K, RT)
    x0, y0 = max(int(np.floor(x0)), 0), max(int(np.floor(y0)), 0)
    x1, y1 = min(int(np.ceil(x1)), W - 1), min(int(np.ceil(y1)), H - 1)
    mask = np.zeros((H, W), np.uint8)
    if x1 > x0 and y1 > y0:
        mask[y0:y1 + 1, x0:x1 + 1] = 1
    return mask
