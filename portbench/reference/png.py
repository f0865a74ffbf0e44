"""A PNG reader for 8-bit RGB and RGBA images, with numpy and zlib only,
to read what a server sends (the PNG specification's chunks, zlib stream
and five row filters)."""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def decode(data: bytes) -> np.ndarray:
    """[H, W, C] uint8 of an 8-bit, non-interlaced RGB (C 3) or RGBA (C 4) PNG."""
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    W, H, depth, color, _, _, interlace = header
    if depth != 8 or color not in (2, 6) or interlace:
        raise ValueError(f"unsupported PNG: depth {depth}, colour type {color}, "
                         f"interlace {interlace}")
    C = 3 if color == 2 else 4
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, 1 + W * C)
    out = np.zeros((H, W * C), np.int32)
    prev = np.zeros(W * C, np.int32)
    for r in range(H):
        f, line = raw[r, 0], raw[r, 1:].astype(np.int32)
        if f == 0:
            cur = line
        elif f == 2:
            cur = (line + prev) & 255
        else:
            cur = np.zeros(W * C, np.int32)
            for x in range(W * C):
                a = cur[x - C] if x >= C else 0
                b = prev[x]
                c = prev[x - C] if x >= C else 0
                pred = {1: a, 3: (a + b) >> 1, 4: _paeth(a, b, c)}[f]
                cur[x] = (line[x] + pred) & 255
        out[r] = prev = cur
    return out.reshape(H, W, C).astype(np.uint8)
