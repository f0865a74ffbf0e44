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

``hashgrid_encode`` takes one of two paths, which compute one function:

- ``encode_fused``, for CUDA points of the corner layout at input dimension
  3 (a bfloat16 or float32 table of 1, 2, 4 or 8 features, at most 32
  levels) that do not require grad, and ``plain=False``: three launches
  forward (``ops/hash_encode.py``'s ``hash_index``, B4, ``hash_interp``) and
  two backward (``hash_interp_bwd``, B4'), with no int64 temporaries and no
  copy from the host. Its indices and the cotangent rows that B4' adds into
  the table's gradient are the other path's bit for bit; its features
  differ only in the order of each 8-term sum.
- ``encode_torch`` for every other call (the CPU, ``plain=True``, cellpack,
  other input dimensions, points that require grad). Its index arithmetic
  runs in int64 and is masked to 32 bits after every product and XOR, which
  is the JAX package's uint32 hash; the dense-level flags are decided on the
  host in Python integers (``res**3`` overflows int32 at the finest levels).

While the program's counters are on (``utils/profiling``) it counts the
points it encodes (``hash.points``) and those that took ``encode_fused``
(``hash.fused_points``).
"""
from __future__ import annotations

import functools
import itertools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..ops import hash_encode, hash_gather
from ..ops.hash_gather import gather_rows_diff
from ..utils.profiling import count

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
    x = torch.clamp(x, 0.0, hash_encode.TOP)
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
    gathers through the plain versions on any device (else the kernels on
    CUDA tensors). Differentiable in the table; the path as the module's
    note says."""
    table = params["table"]
    L, T, W = table.shape
    if resolutions is None:
        resolutions = level_resolutions(L, base_resolution, per_level_scale)
    count("hash.points", pts.shape[0])
    if takes_kernels(table, pts, layout, plain):
        count("hash.fused_points", pts.shape[0])
        return encode_fused(table, pts.float().contiguous(),
                            hash_encode.levels(resolutions, T, bbox_min, bbox_max))
    return encode_torch(table, pts, resolutions, bbox_min, bbox_max, layout, plain)


def takes_kernels(table: torch.Tensor, pts: torch.Tensor, layout: str, plain: bool) -> bool:
    """Whether ``hashgrid_encode`` takes ``encode_fused``."""
    return (pts.is_cuda and not plain and layout == "corner" and pts.dim() == 2
            and pts.shape[1] == 3 and not pts.requires_grad
            and table.dtype in hash_encode.DTYPES and table.shape[2] in hash_encode.FEATURES
            and table.shape[0] <= hash_encode.MAX_LEVELS)


class _FusedEncode(torch.autograd.Function):
    """Forward ``hash_index``, B4, ``hash_interp``; backward
    ``hash_interp_bwd``, B4' (the plain versions on CPU tensors)."""

    @staticmethod
    def forward(ctx, table, pts, lv):
        L, T, F = table.shape
        idx = hash_encode.hash_index(pts, lv)
        rows = hash_gather.gather_rows(table.detach().reshape(L * T, F), idx)
        ctx.save_for_backward(idx, pts)
        ctx.lv, ctx.shape, ctx.dtype = lv, table.shape, table.dtype
        return hash_encode.hash_interp(rows, pts, lv)

    @staticmethod
    def backward(ctx, g):
        idx, pts = ctx.saved_tensors
        L, T, F = ctx.shape
        cot = hash_encode.hash_interp_bwd(g.contiguous(), pts, ctx.lv, ctx.dtype)
        return hash_gather.scatter_add_rows(idx, cot, L * T).view(L, T, F), None, None


def encode_fused(table: torch.Tensor, pts: torch.Tensor, lv: "hash_encode.Levels"
                 ) -> torch.Tensor:
    """The corner layout's encoding of pts [N, 3] float32 through the hash
    encoder's kernels and B4 (see the module's note); differentiable in the
    table."""
    return _FusedEncode.apply(table, pts, lv)


def corner_weights(frac: torch.Tensor) -> torch.Tensor:
    """frac [L, N, D] -> the corners' weights [L, N, 2^D, 1] in product order:
    the product over d of frac_d, or 1 - frac_d for a 0 corner, as D - 1
    multiplies from the first dimension (torch.prod's backward takes a slow
    path over the whole tensor when any factor is 0, a point on a cell face,
    which the gradient with respect to the points meets)."""
    D = frac.shape[-1]
    offs = torch.as_tensor(list(itertools.product((0, 1), repeat=D)), device=frac.device)
    w = torch.where(offs == 1, frac[:, :, None, :], 1.0 - frac[:, :, None, :])
    return functools.reduce(torch.mul, [w[..., d:d + 1] for d in range(D)])


def encode_torch(table: torch.Tensor, pts: torch.Tensor, resolutions, bbox_min: float,
                 bbox_max: float, layout: str, plain: bool) -> torch.Tensor:
    """The encoding in PyTorch's ops around the row gather (``plain``: its
    plain version)."""
    L, T, W = table.shape
    D = pts.shape[-1]
    flat_idx, frac = hashgrid_index(table.shape, pts, resolutions, bbox_min, bbox_max, layout)
    n = pts.shape[0]
    rows = gather_rows_diff(table.reshape(L * T, W), flat_idx, plain)
    F = W >> D if layout == "cellpack" else W
    feats = rows.reshape(L, n, 1 << D, F)  # [L, N, 2^D, F], corners in product order
    out = torch.sum(feats.float() * corner_weights(frac), dim=2)  # [L, N, F]
    return out.permute(1, 0, 2).reshape(n, L * F)


def hashgrid_out_dim(n_levels: int = 16, n_features: int = 2) -> int:
    return n_levels * n_features
