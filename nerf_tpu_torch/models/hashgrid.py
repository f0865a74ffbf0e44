"""Multi-resolution hash-grid encoder; counterpart of ``nerf_tpu/models/hashgrid.py``.

A table per model, [L, T, F] ("corner": each of a point's 8 cell corners is
a row of F features) or [L, T/8, 8F] ("cellpack": one row per cell holding
its 8 corners' features). Level l has resolution floor(base * scale^l);
a level whose dense grid fits in the table is indexed directly, a finer one
through the instant-NGP XOR hash with the primes (1, 2654435761, 805459861)
in wrapping uint32 arithmetic. The features of all levels are fetched in one
row gather (``ops/hash_gather.py``: the B4 kernel on the GPU, whose backward
scatter-adds the table's gradient) and interpolated trilinearly in float32,
whatever the table's dtype.

The index arithmetic runs in int64 and is masked to 32 bits after every
product and XOR, which is the JAX package's uint32 hash; the dense-level
flags are decided on the host in Python integers (``res**3`` overflows int32
at the finest levels).
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops.hash_gather import gather_rows_diff

_PRIMES = (1, 2654435761, 805459861, 3674653429)
_MASK32 = 0xFFFFFFFF


def level_resolutions(n_levels: int = 16, base_resolution: int = 16,
                      per_level_scale: float = 1.3819) -> np.ndarray:
    return np.floor(base_resolution * per_level_scale ** np.arange(n_levels)).astype(np.int32)


def table_shape(n_levels: int = 16, n_features: int = 2, log2_table_size: int = 19,
                layout: str = "corner", input_dim: int = 3) -> Tuple[int, int, int]:
    T = 1 << log2_table_size
    if layout == "cellpack":
        return (n_levels, T >> input_dim, (1 << input_dim) * n_features)
    return (n_levels, T, n_features)


def init_hashgrid(generator: Optional[torch.Generator] = None, n_levels: int = 16,
                  n_features: int = 2, log2_table_size: int = 19, init_scale: float = 1e-4,
                  dtype: torch.dtype = torch.bfloat16, layout: str = "corner",
                  input_dim: int = 3, device=None) -> Dict[str, torch.Tensor]:
    """{"table": U(-init_scale, init_scale) drawn in float32 from ``generator``
    and rounded to ``dtype``}, on ``device``."""
    shape = table_shape(n_levels, n_features, log2_table_size, layout, input_dim)
    table = torch.empty(shape, dtype=torch.float32).uniform_(-init_scale, init_scale,
                                                             generator=generator)
    return {"table": table.to(dtype).to(device)}


def _hash(c: torch.Tensor, n_rows: int) -> torch.Tensor:
    """c [..., D] int64 grid coordinates -> the XOR hash mod n_rows."""
    h = (c[..., 0] * _PRIMES[0]) & _MASK32
    for d in range(1, c.shape[-1]):
        h = h ^ ((c[..., d] * _PRIMES[d]) & _MASK32)
    return h % n_rows


def _direct(c: torch.Tensor, stride: torch.Tensor) -> torch.Tensor:
    """sum_d c_d * stride^d (stride [L, 1], c [L, ..., D]) in int64."""
    idx, mult = c[..., 0], stride
    for d in range(1, c.shape[-1]):
        idx = idx + c[..., d] * mult
        mult = mult * stride
    return idx


def hashgrid_index(table_shape_: Tuple[int, int, int], pts: torch.Tensor,
                   resolutions, bbox_min: float = -2.0, bbox_max: float = 2.0,
                   layout: str = "corner") -> Tuple[torch.Tensor, torch.Tensor]:
    """pts [N, D] -> (flat_idx int32, frac [L, N, D] float32): the rows of the
    table reshaped to [L*T, W] that the encoding reads, level-major ([L*N]
    for cellpack, [L*N*2^D] in corner order for corner), and each point's
    position inside its cell at each level."""
    L, T, _ = table_shape_
    D = pts.shape[-1]
    dev = pts.device
    res_np = np.asarray(resolutions).astype(np.int64)
    res = torch.as_tensor(np.asarray(resolutions), device=dev)
    x = (pts.float() - bbox_min) / (bbox_max - bbox_min)
    x = torch.clamp(x, 0.0, 1.0 - 1e-6)
    xl = x[None] * res[:, None, None].to(torch.float32)  # [L, N, D]
    x0f = torch.floor(xl)
    frac = xl - x0f
    x0 = x0f.to(torch.int64)
    res64 = torch.as_tensor(res_np, device=dev)[:, None]
    if layout == "cellpack":
        dense = torch.as_tensor([int(r) ** D <= T for r in res_np], device=dev)[:, None]
        idx = torch.where(dense, _direct(x0, res64) % T, _hash(x0, T))  # [L, N]
        base = torch.arange(L, device=dev, dtype=torch.int64)[:, None] * T
    else:
        offs = torch.as_tensor(list(itertools.product((0, 1), repeat=D)), device=dev)
        corners = x0[:, :, None, :] + offs  # [L, N, 2^D, D]
        dense = torch.as_tensor([(int(r) + 1) ** D <= T for r in res_np],
                                device=dev)[:, None, None]
        idx = torch.where(dense, _direct(corners, (res64 + 1)[..., None]) % T, _hash(corners, T))
        base = torch.arange(L, device=dev, dtype=torch.int64)[:, None, None] * T
    return (idx + base).reshape(-1).to(torch.int32), frac


def hashgrid_encode(params: Dict[str, torch.Tensor], pts: torch.Tensor, resolutions=None,
                    bbox_min: float = -2.0, bbox_max: float = 2.0, base_resolution: int = 16,
                    per_level_scale: float = 1.3819, layout: str = "corner",
                    plain: bool = False) -> torch.Tensor:
    """pts [N, D] -> features [N, L*F] float32. ``resolutions`` default to
    ``level_resolutions(L, base_resolution, per_level_scale)``. ``plain``
    gathers through the plain versions on any device (else the kernel on
    CUDA tensors). Differentiable in the table."""
    table = params["table"]
    L, T, W = table.shape
    D = pts.shape[-1]
    if resolutions is None:
        resolutions = level_resolutions(L, base_resolution, per_level_scale)
    flat_idx, frac = hashgrid_index(table.shape, pts, resolutions, bbox_min, bbox_max, layout)
    n = pts.shape[0]
    rows = gather_rows_diff(table.reshape(L * T, W), flat_idx, plain)
    F = W >> D if layout == "cellpack" else W
    feats = rows.reshape(L, n, 1 << D, F)  # [L, N, 2^D, F], corners in product order
    offs = torch.as_tensor(list(itertools.product((0, 1), repeat=D)), device=pts.device)
    w = torch.where(offs == 1, frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    # the product over D as D - 1 multiplies: torch.prod's backward takes a
    # slow path over the whole tensor when any factor is 0 (a point on a
    # cell face), which the gradient with respect to the points meets
    w = functools.reduce(torch.mul, [w[..., d:d + 1] for d in range(D)])  # [L, N, 2^D, 1]
    out = torch.sum(feats.float() * w, dim=2)  # [L, N, F]
    return out.permute(1, 0, 2).reshape(n, L * F)


def hashgrid_out_dim(n_levels: int = 16, n_features: int = 2) -> int:
    return n_levels * n_features
