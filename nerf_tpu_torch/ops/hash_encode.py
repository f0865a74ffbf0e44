"""The hash encoder's arithmetic around B4 and B4' as kernels of ``csrc/hash_gather.cu``.

No Pallas kernel of ``nerf_tpu`` does this: the JAX package's encoder
computes its corner rows and interpolation with XLA ops, which XLA fuses.
In eager PyTorch the same ops (``models/hashgrid.py`` ``encode_torch``) are
~40 elementwise launches a forward over int64 temporaries. For the corner
layout at input dimension 3 three kernels take their place:

- ``hash_index(pts, levels)``: pts [N, 3] -> the int32 corner rows
  [L * N * 8] that B4 gathers from the table reshaped to [L * T, F],
  level-major, each point's 8 corners in product order (corner k's offset
  in dimension d is bit 2 - d of k), the level's base l T added;
- ``hash_interp(rows, pts, levels)``: B4's rows [L * N * 8, F] (bfloat16 or
  float32) -> the features [N, L * F] float32, each the corner weights'
  products with the 8 rows summed in float32 as the tree
  ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7));
- ``hash_interp_bwd(g, pts, levels, dtype)``: the features' cotangent
  [N, L * F] float32 -> the rows' cotangent [L * N * 8, F], g w rounded
  once to ``dtype``, which B4' scatter-adds.

The interpolations recompute each point's fractions from the points. Every
step is the float32 arithmetic of ``encode_torch`` as PyTorch runs it on the
device at hand, so on the card the indices and the rows' cotangent equal the
PyTorch path's bit for bit, and the features differ from it only in the
order of the 8 products' sum. ``hash_index_plain``, ``hash_interp_plain``
and ``hash_interp_bwd_plain`` are the same functions in PyTorch, with the
kernels' layouts and order of sums, built on ``models/hashgrid.py``'s
``hashgrid_index`` and ``corner_weights``; the wrappers run them on CPU
tensors.
Each wrapper counts its launches (``.launches``).

``levels(resolutions, n_rows, bbox_min, bbox_max)`` holds what the kernels
take by value: the resolutions, which levels index their lattice directly
(``(res + 1)^3 <= T``), T and the box, with the float32 constants the card
computes from them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import numpy as np
import torch

from . import build, hash_gather

MAX_LEVELS = 32  # csrc/hash_gather.cu's MAX_LEVELS
FEATURES = (1, 2, 4, 8)  # the row widths the interpolation kernels are built for
DTYPES = (torch.bfloat16, torch.float32)
CORNERS = 8
TOP = 1.0 - 1e-6  # the clamp's top, in unit box coordinates


class Levels:
    """The geometry of one table's levels (see the module's note)."""
    __slots__ = ("res", "dense", "n_rows", "bbox_min", "bbox_max", "args")

    def __init__(self, res: Sequence[int], n_rows: int, bbox_min: float, bbox_max: float):
        if not 1 <= len(res) <= MAX_LEVELS:
            raise ValueError(f"hash encoder: {len(res)} levels; the kernels take 1 to "
                             f"{MAX_LEVELS}")
        self.res = tuple(int(r) for r in res)
        self.dense = tuple((r + 1) ** 3 <= n_rows for r in self.res)
        self.n_rows, self.bbox_min, self.bbox_max = int(n_rows), bbox_min, bbox_max
        # a Python scalar as the card's float32 ops take it; the division by
        # the box's size is a product with its float reciprocal there
        inv = np.float32(1.0) / np.float32(bbox_max - bbox_min)
        self.args = (len(self.res), (ctypes.c_int * len(self.res))(*self.res),
                     sum(1 << l for l, d in enumerate(self.dense) if d), self.n_rows,
                     float(np.float32(bbox_min)), float(inv), float(np.float32(TOP)))


@functools.lru_cache(maxsize=64)
def _levels(res: tuple, n_rows: int, bbox_min: float, bbox_max: float) -> Levels:
    return Levels(res, n_rows, bbox_min, bbox_max)


def levels(resolutions, n_rows: int, bbox_min: float, bbox_max: float) -> Levels:
    """The ``Levels`` of a table of T = ``n_rows`` rows a level (kept)."""
    return _levels(tuple(int(r) for r in resolutions), int(n_rows), float(bbox_min),
                   float(bbox_max))


def _torch_index(pts: torch.Tensor, lv: Levels):
    """(the corner rows [L * N * 8] int32, frac [L, N, 3]): ``models/hashgrid.py``
    ``hashgrid_index`` of the corner layout, the one PyTorch version of the
    index arithmetic."""
    from ..models import hashgrid  # which imports this module

    return hashgrid.hashgrid_index((len(lv.res), lv.n_rows, 0), pts, lv.res, lv.bbox_min,
                                   lv.bbox_max)


def _weights(pts: torch.Tensor, lv: Levels) -> torch.Tensor:
    """The corner weights [L, N, 8]: (a0 a1) a2, a_d = frac or 1 - frac."""
    from ..models import hashgrid

    return hashgrid.corner_weights(_torch_index(pts, lv)[1])[..., 0]


def hash_index_plain(pts: torch.Tensor, lv: Levels) -> torch.Tensor:
    """pts [N, 3] -> the corner rows [L * N * 8] int32 (see the module's note)."""
    return _torch_index(pts, lv)[0]


def hash_interp_plain(rows: torch.Tensor, pts: torch.Tensor, lv: Levels) -> torch.Tensor:
    """rows [L * N * 8, F] -> features [N, L * F] float32."""
    L, n, F = len(lv.res), pts.shape[0], rows.shape[1]
    p = rows.float().reshape(L, n, CORNERS, F) * _weights(pts, lv)[..., None]
    pair = lambda a: p[:, :, a] + p[:, :, a + 1]  # noqa: E731
    out = (pair(0) + pair(2)) + (pair(4) + pair(6))  # [L, N, F]
    return out.permute(1, 0, 2).reshape(n, L * F)


def hash_interp_bwd_plain(g: torch.Tensor, pts: torch.Tensor, lv: Levels,
                          dtype: torch.dtype) -> torch.Tensor:
    """g [N, L * F] float32 -> the rows' cotangent [L * N * 8, F] in ``dtype``."""
    L, n = len(lv.res), pts.shape[0]
    F = g.shape[1] // L
    gl = g.float().reshape(n, L, F).permute(1, 0, 2)[:, :, None, :]  # [L, N, 1, F]
    return (gl * _weights(pts, lv)[..., None]).to(dtype).reshape(L * n * CORNERS, F)


def _check_points(pts: torch.Tensor, lv: Levels) -> None:
    if pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"hash encoder: points {tuple(pts.shape)}, expected [N, 3]")
    if len(lv.res) * pts.shape[0] * CORNERS > build.MAX_LAUNCH_ROWS:
        raise ValueError(f"hash encoder: {pts.shape[0]} points x {len(lv.res)} levels in one "
                         f"call; split the points")
    build.check_cuda("pts", pts, torch.float32)


def _launch(fn, *args) -> None:
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {rc}")


def hash_index(pts: torch.Tensor, lv: Levels) -> torch.Tensor:
    """pts [N, 3] float32 -> the corner rows [L * N * 8] int32: the kernel
    for CUDA tensors, the plain version for CPU tensors."""
    if pts.device.type == "cpu":
        return hash_index_plain(pts, lv)
    _check_points(pts, lv)
    idx = torch.empty(len(lv.res) * pts.shape[0] * CORNERS, dtype=torch.int32, device=pts.device)
    _launch(_lib().launch_hash_index, pts.data_ptr(), idx.data_ptr(), pts.shape[0], *lv.args,
            torch.cuda.current_stream(pts.device).cuda_stream)
    hash_index.launches += 1
    return idx


hash_index.launches = 0


def _elem_bytes(dtype: torch.dtype, F: int) -> int:
    if dtype not in DTYPES or F not in FEATURES:
        raise ValueError(f"hash encoder: rows of {F} {dtype}; the kernels take {FEATURES} "
                         f"features of bfloat16 or float32")
    return 2 if dtype == torch.bfloat16 else 4


def hash_interp(rows: torch.Tensor, pts: torch.Tensor, lv: Levels) -> torch.Tensor:
    """rows [L * N * 8, F] bf16/f32 (B4's), pts [N, 3] float32 -> features
    [N, L * F] float32: the kernel for CUDA tensors, the plain version for
    CPU tensors."""
    if rows.device.type == "cpu":
        return hash_interp_plain(rows, pts, lv)
    _check_points(pts, lv)
    L, n, F = len(lv.res), pts.shape[0], rows.shape[1]
    eb = _elem_bytes(rows.dtype, F)
    build.check_cuda("rows", rows, rows.dtype, (L * n * CORNERS, F), align=16)
    out = torch.empty((n, L * F), dtype=torch.float32, device=rows.device)
    _launch(_lib().launch_hash_interp, rows.data_ptr(), pts.data_ptr(), out.data_ptr(), n,
            *lv.args, eb, F, torch.cuda.current_stream(rows.device).cuda_stream)
    hash_interp.launches += 1
    return out


hash_interp.launches = 0


def hash_interp_bwd(g: torch.Tensor, pts: torch.Tensor, lv: Levels,
                    dtype: torch.dtype) -> torch.Tensor:
    """g [N, L * F] float32, pts [N, 3] float32 -> the rows' cotangent
    [L * N * 8, F] in ``dtype`` (bf16/f32): the kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if g.device.type == "cpu":
        return hash_interp_bwd_plain(g, pts, lv, dtype)
    _check_points(pts, lv)
    L, n = len(lv.res), pts.shape[0]
    F = g.shape[1] // L
    eb = _elem_bytes(dtype, F)
    build.check_cuda("g", g, torch.float32, (n, L * F))
    cot = torch.empty((L * n * CORNERS, F), dtype=dtype, device=g.device)
    _launch(_lib().launch_hash_interp_bwd, g.data_ptr(), pts.data_ptr(), cot.data_ptr(), n,
            *lv.args, eb, F, torch.cuda.current_stream(g.device).cuda_stream)
    hash_interp_bwd.launches += 1
    return cot


hash_interp_bwd.launches = 0


def interp_tolerance(rows: torch.Tensor, pts: torch.Tensor, lv: Levels) -> torch.Tensor:
    """Per feature, how far two float32 interpolations of the same rows may
    lie apart when they sum the same 8 products in other orders (the
    kernel's tree, PyTorch's reduction): each within 7 2^-24 S of the exact
    sum, S the sum of the products' magnitudes (here the interpolation of
    |rows|, whose own rounding the 1.01 covers). For a check, not on the path."""
    return 1.01 * 14 * 2.0 ** -24 * hash_interp_plain(rows.abs(), pts, lv)


def encoder_bytes(n_points: int, lv: Levels, n_features: int, elem_bytes: int):
    """{kernel: bytes it must move}: each input read once, each output
    written once (``hash_index``: the points, the indices; ``hash_interp``:
    the points, the rows, the features; ``hash_interp_bwd``: the points, the
    features' cotangent, the rows' cotangent)."""
    L = len(lv.res)
    pts, rows = 12 * n_points, L * n_points * CORNERS * n_features * elem_bytes
    feats = 4 * L * n_points * n_features
    return {"hash_index": pts + 4 * L * n_points * CORNERS, "hash_interp": pts + rows + feats,
            "hash_interp_bwd": pts + feats + rows}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = hash_gather._lib()
    p, i32, u32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    # n_levels, res, dense, T, lo, inv, top: ``Levels.args``
    level_args = [i32, ctypes.POINTER(i32), u32, u32, f32, f32, f32]
    lib.launch_hash_index.argtypes = [p, p, i32, *level_args, p]
    for fn in (lib.launch_hash_interp, lib.launch_hash_interp_bwd):
        fn.argtypes = [p, p, p, i32, *level_args, i32, i32, p]
    for fn in (lib.launch_hash_index, lib.launch_hash_interp, lib.launch_hash_interp_bwd):
        fn.restype = i32
    return lib
