"""What each part of the hash-table row gather (B4) buys: variants of
csrc/hash_gather.cu with one switch changed, built and timed on the GPU.

    python -m nerf_tpu_torch.tools.gather_variants [--reps 50] [--shapes A,B]

Each variant is the source with a line replaced (``VARIANTS``):
  kernel          the gather as it is: 4 rows a thread for rows of 2-8
                  bytes, 2 16-byte vectors a thread for wider rows, indices
                  and output streamed (.cs), table rows with an L2
                  evict_last policy;
  rows_1 .. 8     1, 2, 4 or 8 rows a thread for rows of 2-8 bytes and as
                  many 16-byte vectors a thread for wider rows;
  no_hints        no cache hints: indices and table through the read-only
                  path, plain stores;
  no_evict_last   the table read without the L2 policy;
  indices_cached  indices through the read-only path (no .cs);
  indices_no_allocate  indices by ld.global.nc.L1::no_allocate;
  output_cached   plain stores (no .cs).
Every variant is held exactly against the plain version and timed on seven
row sets (``SHAPES``): a corner NeRF's fine batch (1024 rays of 192 sorted
depths in [2, 6] from a sphere of radius 4 through the scene's box, 16
levels, 8 corners: 25,165,824 rows of 4 bytes), the 4-D and 3-D corner
encoders' rows on 196,608 points at the factory's defaults (50,331,648 and
25,165,824 rows of 4 bytes) and a cellpack fine batch (the same rays:
3,145,728 rows of 32 bytes), both layouts' rows for 196,608 random points
in [-1.5, 1.5]^3 (as ``chip_smoke.py`` phase 3 draws them: 3,145,728 rows
of 32 bytes, 25,165,824 of 4), and a probe of the L2's rate: 50,331,648
uniform rows of a 4 MB table; random bf16 tables of the models' sizes. Each
line gives the time, its share of the bound (``hash_gather.gather_bytes``:
each index, each distinct row and each output row once, at 3.35 TB/s) and
the sector floor (the same at 32-byte grain); the kernel's line also
``torch.index_select`` and, for rows under 16 bytes, the table sector
requests a row that the kernel's warps make (``warp_sectors``) and the rate
through L2 that they imply. Times are CUDA events over ``--reps`` launches,
warm (the table is read again by every launch, as a step's two gathers and
a request's tiles read it), two rounds in opposite orders, each variant in
its own process under a timeout, on one card; the card's name and power
limit head the output. Without a GPU it exits with an error.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

from ..ops import build
from . import scatter_variants, variants

MAIN = build.CSRC / "hash_gather.cu"
OUT_DIR = build.BUILD_DIR / "gather_variants"
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s

_ROWS = "constexpr int ROWS = 4;"
_WIDE = "constexpr int WIDE_VECS = 2;"
_INDEX = "constexpr int INDEX_HINT = 1;"
_OUT = "constexpr bool STREAM_OUTPUT = true;"
_EVICT = "constexpr bool TABLE_EVICT_LAST = true;"


def _rows(k: int):
    return [(_ROWS, f"constexpr int ROWS = {k};"), (_WIDE, f"constexpr int WIDE_VECS = {k};")]


_NO_EVICT = (_EVICT, "constexpr bool TABLE_EVICT_LAST = false;")
_INDEX_CACHED = (_INDEX, "constexpr int INDEX_HINT = 0;")
_OUT_CACHED = (_OUT, "constexpr bool STREAM_OUTPUT = false;")
VARIANTS: variants.Variants = {
    "kernel": [],
    **{f"rows_{k}": _rows(k) for k in (1, 2, 4, 8)},
    "no_hints": [_INDEX_CACHED, _OUT_CACHED, _NO_EVICT],
    "no_evict_last": [_NO_EVICT],
    "indices_cached": [_INDEX_CACHED],
    "indices_no_allocate": [(_INDEX, "constexpr int INDEX_HINT = 2;")],
    "output_cached": [_OUT_CACHED],
}
SHAPES = ("corner NeRF fine batch", "4-D encoder rows", "3-D encoder rows",
          "cellpack fine batch", "cellpack random points", "corner random points", "L2 probe")
PROBE_ROWS, PROBE_N = 1 << 20, 50_331_648  # uniform rows of a 4 MB table of 4-byte rows


def encoder_rows(etype: str, dev, n_points: int = 196_608, seed: int = 7):
    """(table [R, W], idx [N] int32): the rows a factory hash encoder at its
    defaults gathers for n_points points (xyz uniform in [-2, 2]^3, the
    frame uniform in [0, 59] for the 4-D types)."""
    import torch

    from ..models import encoders
    from ..ops import hash_gather

    gen = torch.Generator(device=dev).manual_seed(seed)
    params, fn, _ = encoders.get_encoder({"type": etype}, torch.Generator().manual_seed(0),
                                         device=dev)
    pts = torch.rand((n_points, 3), generator=gen, device=dev) * 4.0 - 2.0
    if etype in encoders.DYNAMIC_HASH_TYPES:
        pts = torch.cat([pts, torch.rand((n_points, 1), generator=gen, device=dev) * 59.0], -1)
    seen = []
    real = hash_gather.gather_rows

    def spy(table, idx):
        seen.append((table.detach(), idx))
        return real(table, idx)

    spy.launches = 0  # the wrapper counts on its module-level name, the spy meanwhile
    hash_gather.gather_rows = spy
    try:
        with torch.no_grad():
            fn(params, pts)
    finally:
        hash_gather.gather_rows = real
    return seen[0]


def shape_rows(name: str, dev, seed: int = 0):
    """(table [R, W] bf16, uniform in [-1, 1), idx [N] int32) of one of ``SHAPES``."""
    import torch

    from ..models.hashgrid import hashgrid_index, level_resolutions, table_shape

    if name == "L2 probe":
        gen = torch.Generator(device=dev).manual_seed(seed + 1)
        idx = torch.randint(0, PROBE_ROWS, (PROBE_N,), generator=gen, device=dev,
                            dtype=torch.int32)
        n_rows, width = PROBE_ROWS, 2
    elif name.endswith("random points"):
        layout = name.split()[0]
        shape = table_shape(16, 2, 19, layout)
        g = torch.Generator(device=dev).manual_seed(seed + 2)
        pts = torch.rand((196_608, 3), generator=g, device=dev) * 3.0 - 1.5
        idx = hashgrid_index(shape, pts, level_resolutions(), layout=layout)[0]
        n_rows, width = shape[0] * shape[1], shape[2]
    elif name.endswith("fine batch"):
        layout = "corner" if name.startswith("corner") else "cellpack"
        shape, idx = scatter_variants.ray_batch_rows(1024, 192, dev, layout=layout)
        n_rows, width = shape[0] * shape[1], shape[2]
    else:
        table, idx = encoder_rows("cuda_hashgrid_4d" if name.startswith("4-D") else "hashgrid",
                                  dev)
        n_rows, width = table.shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    table = (torch.rand((n_rows, width), generator=gen, device=dev) * 2 - 1).to(torch.bfloat16)
    return table, idx.contiguous()


def warp_sectors(idx, row_bytes: int, lane_rows: int) -> float:
    """Table sector requests a row of a gather whose warps' load
    instructions each read row e of 32 lanes that hold lane_rows
    consecutive rows each (lane_rows 1: 32 consecutive rows): the distinct
    32-byte sectors among each instruction's 32 rows, over whole groups of
    32 lane_rows rows. For rows of at most 16 bytes, which lie inside one
    sector."""
    m = idx.shape[0] // (32 * lane_rows) * (32 * lane_rows)
    if m == 0:
        raise ValueError(f"warp_sectors: {idx.shape[0]} rows make no group of {32 * lane_rows}")
    sec = (idx[:m].long() * row_bytes // 32).reshape(-1, 32, lane_rows).sort(dim=1).values
    return float(m // 32 + (sec[:, 1:] != sec[:, :-1]).sum()) / m


def _switch(text: str, name: str) -> int:
    """The value of ``constexpr int <name> = <value>;`` in the source ``text``."""
    return int(text.split(f"constexpr int {name} = ", 1)[1].split(";", 1)[0])


def _time_one(name: str, so: str, reps: int, shapes) -> None:
    """Time one variant library (in this process) and print a line a shape."""
    import torch

    from ..ops import hash_gather

    lib = hash_gather.bind(ctypes.CDLL(so))
    hash_gather._lib = lambda: lib  # the wrappers launch this variant
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def timed(call) -> float:
        rc = call()
        if isinstance(rc, int) and rc != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    for shape in shapes:
        table, idx = shape_rows(shape, dev)
        n, row_b = idx.shape[0], table.shape[1] * table.element_size()
        out = torch.empty((n, table.shape[1]), dtype=table.dtype, device=dev)
        args = (table.data_ptr(), idx.data_ptr(), out.data_ptr(), table.shape[0], n, row_b,
                stream)
        same = torch.equal(hash_gather.gather_rows(table, idx),
                           hash_gather.gather_rows_plain(table, idx))
        ms = timed(lambda: lib.launch_gather_rows(*args))
        bound_b, sector_b = hash_gather.gather_bytes(idx, row_b)
        bound, floor = bound_b / PEAK_BYTES * 1e3, sector_b / PEAK_BYTES * 1e3
        extra = ""
        if name == "kernel":
            lib_ms = timed(lambda: torch.index_select(table, 0, idx))
            extra = f"; torch.index_select {lib_ms:.4f} ms"
            if row_b < 16:
                lane_rows = min(_switch(MAIN.read_text(), "ROWS") * row_b, 16) // row_b
                req = warp_sectors(idx, row_b, lane_rows)
                l2 = req * 32 * n + 4 * n + n * row_b
                extra += (f"; {req:.3f} table sector requests a row, {l2 / 1e9:.3f} GB through "
                          f"L2 at {l2 / ms / 1e9:.2f} TB/s")
        print(f"{name}, {shape} ({n} rows of {row_b} B, {int(torch.unique(idx).numel())} "
              f"distinct): {ms:.4f} ms, {bound / ms:.3f} of the bound {bound:.4f} ms, sector "
              f"floor {floor:.4f} ms; {'exact' if same else 'DIFFERS from plain'}{extra}",
              flush=True)
        del table, idx, out
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--shapes", default=",".join(SHAPES),
                    help="comma-separated row sets to time (default: all of SHAPES)")
    ap.add_argument("--one", nargs=2, metavar=("NAME", "LIB"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        _time_one(*args.one, args.reps, args.shapes.split(","))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("gather_variants: no CUDA device", file=sys.stderr)
        return 1
    print(variants.card(), flush=True)
    built = variants.build_all(MAIN, VARIANTS, OUT_DIR)
    variants.run_rounds("nerf_tpu_torch.tools.gather_variants", built,
                        ["--reps", str(args.reps), "--shapes", args.shapes])
    return 0


if __name__ == "__main__":
    sys.exit(main())
