"""PNG encode and decode with the standard library and numpy.

The JAX package reads and writes images through ``imageio`` and ``cv2``
(``nerf_tpu/data/blender.py:21-31``, ``nerf_tpu/eval/evaluator.py:70-77``);
the port keeps its own codec, which needs neither.

``decode_png`` reads what Blender, imageio, cv2 and ``encode_png`` write:
8-bit gray, gray+alpha, RGB and RGBA, any of the five row filters, the image
data split over any number of IDAT chunks. Anything else (other bit depths,
palettes, Adam7 interlacing) raises ``ValueError`` with the reason, as does a
chunk whose CRC does not match.

Unfiltering is serial along a row for the Avg and Paeth filters: pixel
(r, x) needs (r, x-1), (r-1, x) and (r-1, x-1). ``unfilter`` therefore
sweeps anti-diagonals d = r + x, every row at once: one vector step per
diagonal whatever each row's filter, H + W - 1 steps a frame.
"""
from __future__ import annotations

import struct
import zlib
from typing import Sequence, Union

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for 8-bit samples
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _paeth(a: np.ndarray, b: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The Paeth predictor on int16 arrays (PNG spec 9.4; ties a, then b)."""
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(img: np.ndarray, filters: np.ndarray) -> np.ndarray:
    """[H, W, C] uint8 and a filter type per row -> the filtered scanlines
    [H, 1 + W*C] uint8, each led by its filter byte."""
    h, w, c = img.shape
    x = img.astype(np.int16)
    a = np.zeros_like(x)
    a[:, 1:] = x[:, :-1]
    b = np.zeros_like(x)
    b[1:] = x[:-1]
    cc = np.zeros_like(x)
    cc[1:, 1:] = x[:-1, :-1]
    preds = np.stack([np.zeros_like(x), a, b, (a + b) >> 1, _paeth(a, b, cc)])
    pred = preds[filters, np.arange(h)]
    out = np.empty((h, 1 + w * c), np.uint8)
    out[:, 0] = filters
    out[:, 1:] = ((x - pred) & 0xFF).reshape(h, w * c)
    return out


def encode_png(img: np.ndarray, filters: Union[int, Sequence[int]] = 0,
               level: int = 6) -> bytes:
    """[H, W] or [H, W, C] uint8 (C = 1 gray, 2 gray+alpha, 3 RGB, 4 RGBA) ->
    PNG bytes, 8-bit, one IDAT. ``filters``: the filter type (0-4) of every
    row, or one per row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise ValueError(f"encode_png takes 1-4 channels, got {c}")
    ft = np.broadcast_to(np.asarray(filters, np.int64), (h,))
    if ((ft < 0) | (ft > 4)).any():
        raise ValueError("PNG filter types are 0-4")
    rows = filter_rows(img, ft)
    return (SIGNATURE
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0))
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))


def unfilter(rows: np.ndarray, channels: int) -> np.ndarray:
    """Filtered scanlines [H, 1 + W*C] uint8 -> pixels [H, W, C] uint8, by
    anti-diagonals (module docstring). Raises on a filter type above 4."""
    h = rows.shape[0]
    w = (rows.shape[1] - 1) // channels
    ft = rows[:, 0].astype(np.int64)
    if (ft > 4).any():
        raise ValueError(f"bad PNG filter type {int(ft.max())}")
    filt = rows[:, 1:].reshape(h, w, channels).astype(np.int16)
    # diagonal-major storage with zero padding: pixel (r, x) lives at
    # t[r + x + 2, r + 1], so diagonal d is t[d + 2] and never-written cells
    # (row -1, column -1) read as 0, as the filters define them
    t = np.zeros((h + w + 2, h + 1, channels), np.int16)
    s0, s1, s2 = t.strides
    fd = np.zeros_like(t)
    np.lib.stride_tricks.as_strided(fd[2:, 1:], (h, w, channels), (s0 + s1, s0, s2))[:] = filt
    kind = np.zeros((h + 1, 1), np.int64)
    kind[1:, 0] = ft
    has_avg, has_paeth = bool((ft == 3).any()), bool((ft == 4).any())
    zero = np.zeros((h, channels), np.int16)
    for d in range(h + w - 1):
        r0, r1 = max(0, d - w + 1), min(h - 1, d)
        rows_p = slice(r0 + 1, r1 + 2)  # rows r0..r1, padded index
        a = t[d + 1, rows_p]  # (r, x - 1)
        b = t[d + 1, r0:r1 + 1]  # (r - 1, x)
        z = zero[: r1 - r0 + 1]
        preds = [z, a, b, (a + b) >> 1 if has_avg else z,
                 _paeth(a, b, t[d, r0:r1 + 1]) if has_paeth else z]  # c = (r - 1, x - 1)
        t[d + 2, rows_p] = (fd[d + 2, rows_p] + np.choose(kind[rows_p], preds)) & 0xFF
    pix = np.lib.stride_tricks.as_strided(t[2:, 1:], (h, w, channels), (s0 + s1, s0, s2))
    return pix.astype(np.uint8)


def inflate_png(data: bytes):
    """PNG bytes -> (filtered scanlines [H, 1 + W*C] uint8, C): the chunks
    read (every CRC checked), the header checked, the image data inflated.
    ``zlib`` releases the interpreter lock, so threads can overlap this
    part; ``unfilter`` is numpy steps driven from Python, which they cannot."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        if pos + 12 > len(data):
            raise ValueError("truncated PNG chunk")
        (n,) = struct.unpack(">I", data[pos: pos + 4])
        tag, body = data[pos + 4: pos + 8], data[pos + 8: pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n: pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"bad CRC in {tag!r}")
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + n
    if hdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = hdr
    if depth != 8:
        raise ValueError(f"unsupported PNG bit depth {depth} (8-bit only)")
    if color not in _CHANNELS:
        raise ValueError(f"unsupported PNG colour type {color} (palette or unknown)")
    if interlace:
        raise ValueError("unsupported PNG: Adam7 interlaced")
    c = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (1 + w * c):
        raise ValueError("PNG image data too short")
    return raw[: h * (1 + w * c)].reshape(h, 1 + w * c), c


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> [H, W] uint8 (gray) or [H, W, C] uint8 (C = 2, 3, 4), as
    ``imageio.imread`` returns them."""
    img = unfilter(*inflate_png(data))
    return img[..., 0] if img.shape[-1] == 1 else img


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        return decode_png(f.read())


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
