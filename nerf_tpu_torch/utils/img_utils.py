"""Image utilities; counterpart of ``nerf_tpu/utils/img_utils.py``.

``to8b``, left-to-right and top-to-bottom concatenation, a depth map's
colouring, and PFM read/write: host numpy, as in ``nerf_tpu``.

``colorize_depth`` computes matplotlib's ``jet`` without matplotlib: its
segment data, the 256-entry table matplotlib's ``LinearSegmentedColormap``
builds from it, and matplotlib's index rule (floor(t * 256), t = 1 taken as
255, NaN black). ``nerf_tpu`` asks matplotlib for the colour map and falls
back to gray, silently, where that fails; the port knows ``jet`` only and
raises on any other name.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def to8b(x: np.ndarray) -> np.ndarray:
    return (255 * np.clip(np.asarray(x), 0, 1)).astype(np.uint8)


def horizon_concat(images: Sequence[np.ndarray], pad: int = 0,
                   pad_value: float = 1.0) -> np.ndarray:
    """Concatenate images left-to-right, padding heights to the max."""
    images = [np.asarray(im) for im in images]
    H = max(im.shape[0] for im in images)
    out = []
    for im in images:
        if im.ndim == 2:
            im = im[..., None].repeat(3, -1)
        if im.shape[0] < H:
            fill = np.full((H - im.shape[0], *im.shape[1:]), pad_value, im.dtype)
            im = np.concatenate([im, fill], axis=0)
        out.append(im)
        if pad:
            out.append(np.full((H, pad, im.shape[-1]), pad_value, im.dtype))
    if pad:
        out.pop()
    return np.concatenate(out, axis=1)


def vertical_concat(images: Sequence[np.ndarray], pad: int = 0,
                    pad_value: float = 1.0) -> np.ndarray:
    return np.swapaxes(
        horizon_concat([np.swapaxes(im, 0, 1) for im in images], pad, pad_value), 0, 1)


# matplotlib's jet (matplotlib/_cm.py): per channel, (x, value below x, value above x)
_SEGMENTS = {
    "jet": {"red": ((0.0, 0, 0), (0.35, 0, 0), (0.66, 1, 1), (0.89, 1, 1), (1.0, 0.5, 0.5)),
            "green": ((0.0, 0, 0), (0.125, 0, 0), (0.375, 1, 1), (0.64, 1, 1), (0.91, 0, 0),
                      (1.0, 0, 0)),
            "blue": ((0.0, 0.5, 0.5), (0.11, 1, 1), (0.34, 1, 1), (0.65, 0, 0), (1.0, 0, 0))},
}
LUT_SIZE = 256


def _channel_table(data, n: int = LUT_SIZE) -> np.ndarray:
    """matplotlib's ``_create_lookup_table`` (gamma 1): the segments sampled
    at n evenly spaced points, float64, clipped to [0, 1]."""
    adata = np.asarray(data, np.float64)
    x, y0, y1 = adata[:, 0] * (n - 1), adata[:, 1], adata[:, 2]
    xind = (n - 1) * np.linspace(0, 1, n)
    ind = np.searchsorted(x, xind)[1:-1]
    distance = (xind[1:-1] - x[ind - 1]) / (x[ind] - x[ind - 1])
    lut = np.concatenate([[y1[0]], distance * (y0[ind] - y1[ind - 1]) + y1[ind - 1], [y0[-1]]])
    return np.clip(lut, 0.0, 1.0)


def colormap_table(cmap: str = "jet") -> np.ndarray:
    """[256, 3] float64 rgb table of a colour map the port implements."""
    if cmap not in _SEGMENTS:
        raise ValueError(f"colour map {cmap!r}: the port implements {sorted(_SEGMENTS)}")
    seg = _SEGMENTS[cmap]
    return np.stack([_channel_table(seg[c]) for c in ("red", "green", "blue")], axis=-1)


def apply_colormap(t: np.ndarray, cmap: str = "jet") -> np.ndarray:
    """rgb float64 [..., 3] of t in [0, 1], as matplotlib's Colormap call: the
    index floor(t * 256) in t's own dtype, 256 taken as 255, below 0 the
    first entry, above the last, NaN black."""
    lut = colormap_table(cmap)
    xa = np.array(t, copy=True)
    xa *= LUT_SIZE
    xa[xa == LUT_SIZE] = LUT_SIZE - 1
    under, over, bad = xa < 0, xa >= LUT_SIZE, np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under], idx[over] = 0, LUT_SIZE - 1
    rgb = lut.take(np.where(bad, 0, idx), axis=0)
    rgb[bad] = 0.0
    return rgb


def colorize_depth(depth: np.ndarray, near: float = None, far: float = None,
                   cmap: str = "jet") -> np.ndarray:
    """Depth map -> rgb float32 in [0, 1]: depth normalised by [near, far]
    (default: its finite 1st and 99th percentiles), clipped, coloured."""
    d = np.asarray(depth, np.float32)
    lo = near if near is not None else np.percentile(d[np.isfinite(d)], 1)
    hi = far if far is not None else np.percentile(d[np.isfinite(d)], 99)
    t = np.clip((d - lo) / max(hi - lo, 1e-8), 0, 1)
    return apply_colormap(t, cmap).astype(np.float32)


def read_pfm(path):
    """Read a PFM (portable float map) -> (array [H,W(,3)], scale). PFM
    stores rows bottom to top; the sign of the scale gives the byte order."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")
        line = f.readline().strip()
        while line.startswith(b"#"):
            line = f.readline().strip()
        w, h = (int(v) for v in line.split())
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(4 * w * h * channels), dtype)
    shape = (h, w, 3) if channels == 3 else (h, w)
    return np.ascontiguousarray(data.reshape(shape)[::-1]), abs(scale)


def write_pfm(path, image, scale=1.0):
    """Write a PFM file (little-endian; rows stored bottom-to-top)."""
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        header = b"PF"
    elif image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 1):
        header = b"Pf"
        image = image.reshape(image.shape[0], image.shape[1])
    else:
        raise ValueError(f"unsupported PFM shape {image.shape}")
    with open(path, "wb") as f:
        f.write(header + b"\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())
        f.write(image[::-1].astype("<f4").tobytes())
