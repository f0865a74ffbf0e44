"""Lens undistortion and nearest-neighbour resizing with cv2's arithmetic, without cv2.

The JAX package's light-stage loader calls ``cv2.undistort`` and
``cv2.resize``; the card's machine has no cv2, so the port computes what
they compute:

- ``undistort_map``: the map of ``cv2.undistort(img, K, D)`` (new camera
  matrix K, no rotation), built as cv2 builds it: in stripes of
  max(1, 4096 // W) rows, each with the principal point moved up by the
  stripe's first row, through cv2's closed-form 3x3 inverse; each pixel's
  undistorted ray pushed through the distortion model (k1, k2, p1, p2[, k3
  [, k4, k5, k6]]) in float64, and the source position rounded to 1/32 of a
  pixel (round half to even): an integer pixel and a 5-bit fraction a
  coordinate.
- ``remap_linear``: cv2's bilinear remap on that map, the border constant
  0. The four weights of a fraction pair are products of multiples of 1/32,
  exact in float32: a float image sums its four taps in float32 in cv2's
  order; a uint8 image (the masks) uses them as 15-bit integers (exact, they
  sum to 32768) and rounds (sum + 2^14) >> 15, so a 0/1 mask stays 0/1 as
  cv2 leaves it.
- ``resize_nearest``: INTER_NEAREST, source index floor(x / ratio).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

INTER_BITS = 5
TAB = 1 << INTER_BITS  # fractions of a pixel
COEF_BITS = 15  # the integer weights' scale


def _invert3(a: np.ndarray) -> np.ndarray:
    """cv2's 3x3 inverse (``invert`` with DECOMP_LU for n = 3): cofactors
    over the determinant, in float64."""
    det = (a[0, 0] * (a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1])
           - a[0, 1] * (a[1, 0] * a[2, 2] - a[1, 2] * a[2, 0])
           + a[0, 2] * (a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]))
    d = 1.0 / det
    return np.array([
        [(a[1, 1] * a[2, 2] - a[1, 2] * a[2, 1]) * d, (a[0, 2] * a[2, 1] - a[0, 1] * a[2, 2]) * d,
         (a[0, 1] * a[1, 2] - a[0, 2] * a[1, 1]) * d],
        [(a[1, 2] * a[2, 0] - a[1, 0] * a[2, 2]) * d, (a[0, 0] * a[2, 2] - a[0, 2] * a[2, 0]) * d,
         (a[0, 2] * a[1, 0] - a[0, 0] * a[1, 2]) * d],
        [(a[1, 0] * a[2, 1] - a[1, 1] * a[2, 0]) * d, (a[0, 1] * a[2, 0] - a[0, 0] * a[2, 1]) * d,
         (a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0]) * d]])


def _coefficients(D) -> Tuple[float, ...]:
    """(k1, k2, p1, p2, k3, k4, k5, k6) from 4, 5 or 8 distortion coefficients."""
    d = np.asarray(D, np.float64).reshape(-1)
    if d.size not in (4, 5, 8):
        raise ValueError(f"distortion coefficients: 4, 5 or 8 supported, got {d.size}")
    return tuple(np.concatenate([d, np.zeros(8 - d.size)]))


def undistort_map(K: np.ndarray, D, H: int, W: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(ix, iy, frac) [H, W]: for each output pixel the source pixel (int64,
    may lie outside the image) and the fraction index fy * 32 + fx."""
    A = np.asarray(K, np.float64)
    k1, k2, p1, p2, k3, k4, k5, k6 = _coefficients(D)
    fx, fy, u0, v0 = A[0, 0], A[1, 1], A[0, 2], A[1, 2]
    stripe = min(max(1, (1 << 12) // max(W, 1)), H)
    iu = np.empty((H, W), np.int64)
    iv = np.empty((H, W), np.int64)
    j = np.arange(W, dtype=np.float64)[None, :]
    for y0 in range(0, H, stripe):
        rows = min(stripe, H - y0)
        Ar = A.copy()
        Ar[1, 2] = v0 - y0
        ir = _invert3(Ar).reshape(-1)
        i = np.arange(rows, dtype=np.float64)[:, None]
        _x = i * ir[1] + ir[2] + j * ir[0]
        _y = i * ir[4] + ir[5] + j * ir[3]
        _w = i * ir[7] + ir[8] + j * ir[6]
        w = 1.0 / _w
        x, y = _x * w, _y * w
        x2, y2 = x * x, y * y
        r2 = x2 + y2
        _2xy = 2 * x * y
        kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
        u = fx * (x * kr + p1 * _2xy + p2 * (r2 + 2 * x2)) + u0
        v = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * _2xy) + v0
        iu[y0:y0 + rows] = np.rint(u * TAB)
        iv[y0:y0 + rows] = np.rint(v * TAB)
    return iu >> INTER_BITS, iv >> INTER_BITS, (iv & (TAB - 1)) * TAB + (iu & (TAB - 1))


def _taps(img: np.ndarray, ix: np.ndarray, iy: np.ndarray):
    """The four taps (x, y), (x+1, y), (x, y+1), (x+1, y+1) of every output
    pixel, 0 outside the image."""
    H, W = img.shape[:2]
    out = []
    for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
        x, y = ix + dx, iy + dy
        inside = (x >= 0) & (x < W) & (y >= 0) & (y < H)
        v = img[np.clip(y, 0, H - 1), np.clip(x, 0, W - 1)]
        mask = inside if v.ndim == inside.ndim else inside[..., None]
        out.append(np.where(mask, v, np.zeros((), img.dtype)))
    return out


def remap_linear(img: np.ndarray, ix: np.ndarray, iy: np.ndarray,
                 frac: np.ndarray) -> np.ndarray:
    """cv2.remap(img, map, INTER_LINEAR, BORDER_CONSTANT 0) of a float32 or
    uint8 image [H, W] or [H, W, C] on ``undistort_map``'s map."""
    fx = (frac & (TAB - 1)).astype(np.float32) / TAB
    fy = (frac >> INTER_BITS).astype(np.float32) / TAB
    weights = [(1 - fy) * (1 - fx), (1 - fy) * fx, fy * (1 - fx), fy * fx]
    extra = (slice(None), slice(None)) + (None,) * (img.ndim - 2)
    taps = _taps(img, ix, iy)
    if img.dtype == np.uint8:
        acc = sum(t.astype(np.int64) * (w * (1 << COEF_BITS)).astype(np.int64)[extra]
                  for t, w in zip(taps, weights))
        return np.clip((acc + (1 << (COEF_BITS - 1))) >> COEF_BITS, 0, 255).astype(np.uint8)
    if img.dtype != np.float32:
        raise ValueError(f"remap_linear: float32 or uint8, got {img.dtype}")
    acc = taps[0] * weights[0][extra]
    for t, w in zip(taps[1:], weights[1:]):
        acc = acc + t * w[extra]
    return acc


def undistort(img: np.ndarray, K: np.ndarray, D) -> np.ndarray:
    """cv2.undistort(img, K, D): the image as an ideal pinhole camera K sees it."""
    H, W = img.shape[:2]
    return remap_linear(img, *undistort_map(K, D, H, W))


def resize_nearest(img: np.ndarray, ratio: float) -> np.ndarray:
    """cv2.resize(img, None, fx=ratio, fy=ratio, interpolation=INTER_NEAREST):
    round(H ratio) x round(W ratio), source index min(floor(x / ratio), W - 1)."""
    H, W = img.shape[:2]
    h, w = int(np.rint(H * ratio)), int(np.rint(W * ratio))
    ys = np.minimum(np.floor(np.arange(h) * (1.0 / ratio)).astype(np.int64), H - 1)
    xs = np.minimum(np.floor(np.arange(w) * (1.0 / ratio)).astype(np.int64), W - 1)
    return img[ys[:, None], xs[None, :]]
