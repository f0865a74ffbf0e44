"""Hash-table row gather (B4) and its scatter-add backward; counterpart of
``nerf_tpu/ops/hash_gather.py``.

``gather_rows(table, idx)`` is ``table[idx]`` for a 2D bf16 or float32
table and int32 indices: on CUDA tensors it launches the kernel of
``csrc/hash_gather.cu`` (the port of the Pallas ``_gather_kernel``,
``nerf_tpu/ops/hash_gather.py:45``), on CPU tensors it runs
``gather_rows_plain``. ``scatter_add_rows(idx, cot, n_rows)`` is its
transpose, the table's gradient: the kernel accumulates in float32 with
atomics and rounds once to the cotangent's dtype; ``scatter_add_rows_plain``
does the same with ``index_add_`` on a float32 buffer. In the JAX package
the hash encoder gathers with XLA, and its backward is XLA's scatter-add in
the table's dtype (the slotpack VJP); the port's float32 accumulation is
the difference, bounded in ``tests/test_torch_hashgrid.py``.

``gather_rows_diff`` is the differentiable gather the hash encoder calls.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build

_DTYPES = (torch.bfloat16, torch.float32)


def gather_rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, W], idx [N] int -> [N, W]."""
    return table[idx.long()]


def scatter_add_rows_plain(idx: torch.Tensor, cot: torch.Tensor, n_rows: int) -> torch.Tensor:
    """grad [n_rows, W] in cot's dtype: the rows of cot [N, W] summed at idx
    [N] in float32, then rounded once."""
    acc = torch.zeros((n_rows, cot.shape[1]), dtype=torch.float32, device=cot.device)
    acc.index_add_(0, idx.long(), cot.float())
    return acc.to(cot.dtype)


def scatter_add_tolerance(idx: torch.Tensor, cot: torch.Tensor, want: torch.Tensor
                          ) -> torch.Tensor:
    """Per element, how far two ``scatter_add_rows`` results of the same
    inputs may lie apart, ``want`` being one of them: each sums its n
    float32 terms in some order (within (n - 1) 2^-24 S of the exact sum, S
    the sum of the terms' magnitudes) and, for bf16, rounds once (2^-8 of
    the value). So |a - want| <= 2.01 n 2^-24 S, plus 1.01 x 2^-7 |want| for
    bf16. For a check, not on the path: it scatters twice more in float64."""
    i = idx.long()
    c64 = cot.double()
    mag = torch.zeros(want.shape, dtype=torch.float64, device=cot.device).index_add_(
        0, i, c64.abs())
    cnt = torch.zeros((want.shape[0], 1), dtype=torch.float64, device=cot.device).index_add_(
        0, i, torch.ones((i.shape[0], 1), dtype=torch.float64, device=cot.device))
    tol = 2.01 * cnt * 2.0 ** -24 * mag
    if cot.dtype == torch.bfloat16:
        tol = tol + 1.01 * 2.0 ** -7 * want.double().abs()
    return tol


def _check(idx: torch.Tensor, rows: torch.Tensor, what: str) -> None:
    if idx.dim() != 1 or rows.dim() != 2:
        raise ValueError(f"{what}: need idx [N] and a 2D tensor, got {tuple(idx.shape)} "
                         f"and {tuple(rows.shape)}")
    if rows.dtype not in _DTYPES:
        raise ValueError(f"{what}: dtype {rows.dtype}, expected bfloat16 or float32")
    if idx.shape[0] > build.MAX_LAUNCH_ROWS:
        raise ValueError(f"{what}: {idx.shape[0]} rows in one call; split the indices")


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table [R, W] bf16/f32, idx [N] int32 -> table[idx] [N, W]: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Indices must
    lie in [0, R); the kernel traps on any other."""
    if table.device.type == "cpu":
        return gather_rows_plain(table, idx)
    _check(idx, table, "gather_rows")
    n = idx.shape[0]
    build.check_cuda("table", table, table.dtype, align=16)
    build.check_cuda("idx", idx, torch.int32, (n,))
    out = torch.empty((n, table.shape[1]), dtype=table.dtype, device=table.device)
    rc = _lib().launch_gather_rows(table.data_ptr(), idx.data_ptr(), out.data_ptr(),
                                   table.shape[0], n, table.shape[1] * table.element_size(),
                                   torch.cuda.current_stream(table.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_rows kernel launch failed: CUDA error {rc}")
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def scatter_add_rows(idx: torch.Tensor, cot: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The transpose of ``gather_rows``: grad [n_rows, W] in cot's dtype, the
    rows of cot [N, W] summed at idx [N] int32 in float32 and rounded once.
    The CUDA kernel for CUDA tensors (float32 atomics: the order of the sums,
    and so their last bits, change from run to run), the plain version for
    CPU tensors."""
    if cot.device.type == "cpu":
        return scatter_add_rows_plain(idx, cot, n_rows)
    _check(idx, cot, "scatter_add_rows")
    n, width = cot.shape
    build.check_cuda("idx", idx, torch.int32, (n,))
    build.check_cuda("cot", cot, cot.dtype, (n, width))
    acc = torch.empty((n_rows, width), dtype=torch.float32, device=cot.device)
    out = acc if cot.dtype == torch.float32 else torch.empty((n_rows, width), dtype=cot.dtype,
                                                             device=cot.device)
    rc = _lib().launch_scatter_add_rows(idx.data_ptr(), cot.data_ptr(), acc.data_ptr(),
                                        out.data_ptr(), n_rows, n, width,
                                        int(cot.dtype == torch.bfloat16),
                                        torch.cuda.current_stream(cot.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: CUDA error {rc}")
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load("hash_gather")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.launch_gather_rows.argtypes = [p, p, p, i64, i32, i32, p]
    lib.launch_gather_rows.restype = i32
    lib.launch_scatter_add_rows.argtypes = [p, p, p, p, i64, i32, i32, i32, p]
    lib.launch_scatter_add_rows.restype = i32
    return lib


class _GatherRows(torch.autograd.Function):
    """Forward ``gather_rows``, backward ``scatter_add_rows`` (or the plain versions)."""

    @staticmethod
    def forward(ctx, table, idx, plain):
        ctx.save_for_backward(idx)
        ctx.n_rows, ctx.plain = table.shape[0], plain
        return (gather_rows_plain if plain else gather_rows)(table.detach(), idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        fn = scatter_add_rows_plain if ctx.plain else scatter_add_rows
        return fn(idx, g.contiguous(), ctx.n_rows), None, None


def gather_rows_diff(table: torch.Tensor, idx: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """Differentiable ``gather_rows``: the table gets the scatter-added
    gradient. ``plain=True`` takes the plain versions on any device."""
    return _GatherRows.apply(table, idx, plain)
