"""Hash-table row gather (B4) and its scatter-add backward; counterpart of
``nerf_tpu/ops/hash_gather.py``.

``gather_rows(table, idx)`` is ``table[idx]`` for a 2D bf16 or float32
table and int32 indices: on CUDA tensors it launches the kernel of
``csrc/hash_gather.cu`` (the port of the Pallas ``_gather_kernel``,
``nerf_tpu/ops/hash_gather.py:45``), on CPU tensors it runs
``gather_rows_plain``. ``scatter_add_rows(idx, cot, n_rows)`` is its
transpose, the table's gradient: the kernel sums runs of equal indices
within a warp in registers, adds each run's sum into a float32 buffer with
vector reductions and rounds once to the cotangent's dtype;
``scatter_add_rows_plain`` does the same with ``index_add_`` on a float32
buffer. ``scatter_add_rows_atomic`` launches the previous kernel (one
float32 atomic per element), kept for comparison; ``warp_runs`` and
``scatter_add_rows_runs`` repeat the kernel's runs and order of sums in
PyTorch for the CPU tests. In the JAX package
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


def warp_runs(idx: torch.Tensor):
    """The kernel's runs: the rows of each warp (32 consecutive rows, the
    last warp padded with index -1) split where the index changes. Returns
    (lane [N'], start [N'], last [N']) for the N' = 32 ceil(N / 32) padded
    rows: each row's lane, the lane its run starts at, whether it ends it."""
    n = idx.shape[0]
    pad = torch.full((-n % 32,), -1, dtype=idx.dtype, device=idx.device)
    r = torch.cat([idx, pad]).reshape(-1, 32)
    lane = torch.arange(32, device=idx.device).expand_as(r)
    head = torch.ones_like(r, dtype=torch.bool)
    head[:, 1:] = r[:, 1:] != r[:, :-1]
    start = torch.cummax(torch.where(head, lane, 0), dim=1).values
    last = torch.ones_like(head)
    last[:, :-1] = head[:, 1:]
    return lane.reshape(-1), start.reshape(-1), last.reshape(-1)


def lanes_per_row(width: int) -> int:
    """How many lanes of the kernel's warp share a row: 4 for widths 16
    divides, 2 for 8, else 1 (each lane holding 4, 2 or 1 of its floats)."""
    return 4 if width % 16 == 0 else 2 if width % 8 == 0 else 1


def scatter_add_rows_runs(idx: torch.Tensor, cot: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``scatter_add_rows``'s result summed as its kernel sums (for the
    tests): each warp's 32 rows in P = ``lanes_per_row`` groups of 32 / P;
    in each group a segmented inclusive scan in float32 (steps of 1, 2, 4,
    ... rows, a row adding only from its own run), plus the run's sum at the
    group before's last row where the run began there; each run's sum then
    added at its index, rounded once to cot's dtype."""
    lane, start, last = warp_runs(idx)
    n, width = cot.shape
    p = lanes_per_row(width)
    g_rows = 32 // p
    v = torch.zeros((lane.shape[0], width), dtype=torch.float32, device=cot.device)
    v[:n] = cot.float()
    v = v.reshape(-1, 32, width)
    lane, start = lane.reshape(-1, 32), start.reshape(-1, 32)
    for g in range(p):
        rows = slice(g * g_rows, (g + 1) * g_rows)
        vg, rho, st = v[:, rows], lane[:, rows], start[:, rows]
        off = 1
        while off < g_rows:
            take = ((rho - off >= st) & (rho - g * g_rows >= off))[..., None]
            vg = vg + torch.where(take, torch.nn.functional.pad(vg, (0, 0, off, 0))[:, :g_rows],
                                  0.0)
            off *= 2
        if g > 0:
            vg = vg + torch.where((st < g * g_rows)[..., None], v[:, g * g_rows - 1][:, None], 0.0)
        v = torch.cat([v[:, :g * g_rows], vg, v[:, (g + 1) * g_rows:]], dim=1)
    keep = last[:n]
    acc = torch.zeros((n_rows, width), dtype=torch.float32, device=cot.device)
    acc.index_add_(0, idx[keep].long(), v.reshape(-1, width)[:n][keep])
    return acc.to(cot.dtype)


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
    The CUDA kernel for CUDA tensors (float32 reductions: the order of the
    sums, and so their last bits, change from run to run), the plain version
    for CPU tensors."""
    if cot.device.type == "cpu":
        return scatter_add_rows_plain(idx, cot, n_rows)
    out = _scatter(_lib().launch_scatter_add_rows, idx, cot, n_rows)
    scatter_add_rows.launches += 1
    return out


scatter_add_rows.launches = 0


def scatter_add_rows_atomic(idx: torch.Tensor, cot: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The previous scatter-add kernel (one float32 atomicAdd per element,
    ``launch_scatter_add_rows_atomic``), CUDA tensors only. No path of the
    port calls it: it is the yardstick that the GPU tests and
    ``chip_smoke.py`` hold ``scatter_add_rows`` against."""
    return _scatter(_lib().launch_scatter_add_rows_atomic, idx, cot, n_rows)


def _scatter(fn, idx, cot, n_rows):
    _check(idx, cot, "scatter_add_rows")
    n, width = cot.shape
    build.check_cuda("idx", idx, torch.int32, (n,))
    build.check_cuda("cot", cot, cot.dtype, (n, width))
    acc = torch.empty((n_rows, width), dtype=torch.float32, device=cot.device)
    out = acc if cot.dtype == torch.float32 else torch.empty((n_rows, width), dtype=cot.dtype,
                                                             device=cot.device)
    rc = fn(idx.data_ptr(), cot.data_ptr(), acc.data_ptr(), out.data_ptr(), n_rows, n, width,
            int(cot.dtype == torch.bfloat16), torch.cuda.current_stream(cot.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"scatter_add_rows kernel launch failed: CUDA error {rc}")
    return out


@functools.cache
def _lib() -> ctypes.CDLL:
    return bind(build.load("hash_gather"))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of a built ``csrc/hash_gather.cu``'s exports."""
    p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.launch_gather_rows.argtypes = [p, p, p, i64, i32, i32, p]
    lib.launch_gather_rows.restype = i32
    for fn in (lib.launch_scatter_add_rows, lib.launch_scatter_add_rows_atomic):
        fn.argtypes = [p, p, p, p, i64, i32, i32, i32, p]
        fn.restype = i32
    lib.launch_scatter_add_rows_part.argtypes = [p, p, p, p, i64, i32, i32, i32, i32, p]
    lib.launch_scatter_add_rows_part.restype = i32
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
