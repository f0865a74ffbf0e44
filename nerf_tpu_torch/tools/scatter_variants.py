"""What each part of the hash table's scatter-add (B4's backward) costs:
variants of csrc/hash_gather.cu with one part taken out or switched, built
and timed on the GPU.

    python -m nerf_tpu_torch.tools.scatter_variants [--rays 1024] [--samples 192] [--reps 20]

Each variant is the source with a line replaced (``VARIANTS``):
  kernel          the scatter-add as it is;
  no_memset       the float32 buffer is not zeroed (its sums grow from call
                  to call): the memset's cost;
  no_round        no rounding pass to bf16: its cost;
  scalar_atomics  one scalar float32 atomicAdd per element of a run's sum
                  instead of red.global.add.v4.f32 (four per 16-float row);
  no_aggregation  every row adds itself: no sums of runs of equal indices.
The variants that compute the function (kernel, scalar_atomics,
no_aggregation) are held against the plain version within
``scatter_add_tolerance``. Each line gives the whole scatter-add and its
three launches alone (memset, accumulation, rounding); the kernel's line
also the runs of equal indices in warps of 32 rows and the distinct rows.
The input is a hash-grid train step's fine batch as the encoder
indexes it: ``--rays`` rays of ``--samples`` sorted depths in [2, 6] from a
sphere of radius 4 through the scene's box, 16 levels, the cellpack table
[16 x 65,536, 16] bf16, bf16 cotangents. Times are CUDA events over
``--reps`` calls, two rounds in opposite orders, each variant in its own
process under a timeout, on one card; the card's name and power limit head
the output. Without a GPU it exits with an error.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

from ..ops import build
from . import variants

MAIN = build.CSRC / "hash_gather.cu"
OUT_DIR = build.BUILD_DIR / "scatter_variants"
_MEMSET = "  int err = scatter_part(0, idx, cot, acc, out, n_rows, n, width, bf16, s);\n"
_ROUND = "  if (!err) err = scatter_part(2, idx, cot, acc, out, n_rows, n, width, bf16, s);\n"

VARIANTS: variants.Variants = {
    "kernel": [],
    "no_memset": [(_MEMSET, "  int err = 0;\n")],
    "no_round": [(_ROUND, "")],
    "scalar_atomics": [("constexpr bool VECTOR_RED = true;", "constexpr bool VECTOR_RED = false;")],
    "no_aggregation": [("constexpr bool AGGREGATE = true;", "constexpr bool AGGREGATE = false;")],
    "lane_per_row": [("constexpr int MAX_LANES_PER_ROW = 4;", "constexpr int MAX_LANES_PER_ROW = 1;")],
}
SAME_FUNCTION = ("kernel", "scalar_atomics", "no_aggregation", "lane_per_row")


MIXES = ("equal", "run31", "run32", "run33", "run1000", "sorted", "uniform")


def index_mix(kind: str, n: int, n_rows: int, gen):
    """n int32 indices into n_rows on gen's device, one of ``MIXES``: all one
    row; runs of L equal indices that start 7 rows into a warp, so that they
    cross warp edges; sorted; uniform."""
    import torch

    dev = gen.device
    if kind == "equal":
        idx = torch.randint(0, n_rows, (1,), generator=gen, device=dev).expand(n)
    elif kind.startswith("run"):
        run = int(kind[3:])
        rows = torch.randint(0, n_rows, ((n + 7) // run + 1,), generator=gen, device=dev)
        idx = rows[(torch.arange(n, device=dev) + 7) // run]
    elif kind in ("sorted", "uniform"):
        idx = torch.randint(0, n_rows, (n,), generator=gen, device=dev)
        if kind == "sorted":
            idx = torch.sort(idx).values
    else:
        raise ValueError(f"unknown index mix {kind!r}")
    return idx.to(torch.int32).contiguous()


def ray_batch_rows(n_rays: int, n_samples: int, dev, seed: int = 0, layout: str = "cellpack"):
    """(table shape, idx int32): the rows the hash encoder reads for a batch
    of rays through the scene, level-major: 16 n_rays n_samples cellpack
    rows, or 8 times as many corner rows."""
    import torch

    from ..models.hashgrid import hashgrid_index, level_resolutions, table_shape

    gen = torch.Generator(device=dev).manual_seed(seed)
    o = torch.randn((n_rays, 3), generator=gen, device=dev)
    o = 4.0 * o / o.norm(dim=-1, keepdim=True)
    d = (torch.rand((n_rays, 3), generator=gen, device=dev) * 2.0 - 1.0) - o
    d = d / d.norm(dim=-1, keepdim=True)
    z = torch.sort(torch.rand((n_rays, n_samples), generator=gen, device=dev) * 4.0 + 2.0,
                   -1).values
    pts = (o[:, None] + z[..., None] * d[:, None]).reshape(-1, 3)
    shape = table_shape(16, 2, 19, layout)
    return shape, hashgrid_index(shape, pts, level_resolutions(), layout=layout)[0]


def _time_one(name: str, so: str, n_rays: int, n_samples: int, reps: int) -> None:
    """Time one variant library (in this process) and print one line."""
    import torch

    from ..ops import hash_gather

    lib = hash_gather.bind(ctypes.CDLL(so))
    hash_gather._lib = lambda: lib  # the wrappers launch this variant
    dev = torch.device("cuda")
    shape, idx = ray_batch_rows(n_rays, n_samples, dev)
    n, n_rows, width = idx.shape[0], shape[0] * shape[1], shape[2]
    gen = torch.Generator(device=dev).manual_seed(1)
    cot = torch.randn((n, width), generator=gen, device=dev).to(torch.bfloat16)
    acc = torch.empty((n_rows, width), device=dev)
    out = torch.empty((n_rows, width), dtype=torch.bfloat16, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    args = (idx.data_ptr(), cot.data_ptr(), acc.data_ptr(), out.data_ptr(), n_rows, n, width, 1)

    def timed(call) -> float:
        if call() != 0:
            raise RuntimeError(f"{name}: launch failed")
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            call()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    total = timed(lambda: lib.launch_scatter_add_rows(*args, stream))
    parts = ", ".join(f"{p} {timed(lambda: lib.launch_scatter_add_rows_part(*args, i, stream)):.4f}"
                      for i, p in enumerate(("memset", "accumulate", "round")))
    extra = ""
    if name in SAME_FUNCTION:
        got = hash_gather.scatter_add_rows(idx, cot, n_rows)
        want = hash_gather.scatter_add_rows_plain(idx, cot, n_rows)
        tol = hash_gather.scatter_add_tolerance(idx, cot, want)
        worst = float(((got.double() - want.double()).abs() / tol.clamp_min(1e-30)).max())
        extra = f"; worst err / tolerance against the plain version {worst:.3g}"
    if name == "kernel":
        runs = int(hash_gather.warp_runs(idx)[2][:n].sum())
        extra += (f"; {runs} runs in warps of 32 rows, {int(torch.unique(idx).numel())} "
                  f"distinct rows")
    print(f"{name}: {total:.4f} ms on {n} rows of {width} bf16 ({parts}){extra}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rays", type=int, default=1024)
    ap.add_argument("--samples", type=int, default=192)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--one", nargs=2, metavar=("NAME", "LIB"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        _time_one(*args.one, args.rays, args.samples, args.reps)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("scatter_variants: no CUDA device", file=sys.stderr)
        return 1
    print(variants.card(), flush=True)
    built = variants.build_all(MAIN, VARIANTS, OUT_DIR)
    variants.run_rounds("nerf_tpu_torch.tools.scatter_variants", built,
                        ["--rays", str(args.rays), "--samples", str(args.samples),
                         "--reps", str(args.reps)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
