"""What each part of B2-f32's weight gradients (3xTF32 on the tensor cores)
buys: variants of csrc/fused_mlp_bwd_f32.cu, built and timed on the GPU.

    python -m nerf_tpu_torch.tools.bwd_f32_variants [--points 196608] [--reps 5]
        [--only kernel,tf32x1] [--times-only] [--splits 11,22,33]

Each variant is the source with a line replaced (``VARIANTS``) or another
unit table (``TABLES``):
  kernel      the weight gradients as they are: 3xTF32 products over a
              4-stage TMA ring, the biases folded into the weight units, the
              products' sum promoted into a register sum every 8 stages;
  tf32x1      one TF32 product a k-step (hi hi, no lo terms): what the two
              extra passes buy in accuracy and cost in time;
  no_fold     the biases as units of their own (``dw_units(fold_bias=False)``),
              each streaming its G columns again;
  one_stage   a ring of one stage: no load overlaps the products;
  no_promote  the products summed on the tensor cores over the whole point
              range, never promoted;
  loads_only  (timing only) the ring and the split, no products;
  stream_only (timing only) the ring alone: no split, no products;
  compute_only (timing only) no loads and no split: the products on
              whatever shared memory holds, the consumers' own time.
Each line gives the weight-gradient launch alone and the whole backward (ms,
CUDA events over ``--reps`` launches) on ``--points`` random points of the
lego fine model (float32 weights, no input gradients, as the train step
calls it), and each variant's distance from the plain backward summed in
float64: the largest max|k - p64| / max|p64| over the 32 gradient leaves,
with the points in the wrapper's ranges and in one range (every point summed
by one block: how the distance grows with the points a range sums), beside
the plain version in float32. Two rounds in opposite orders, each variant in
its own process under a timeout; the card's name and power limit head the
output. ``--only`` picks variants, ``--times-only`` leaves out the float64
distances, ``--splits`` also times the kernel's weight gradients with each
of those point-range counts. Without a GPU it exits with an error.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

from ..ops import build
from . import variants

MAIN = build.CSRC / "fused_mlp_bwd_f32.cu"
OUT_DIR = build.BUILD_DIR / "bwd_f32_variants"

VARIANTS: variants.Variants = {
    "kernel": [],
    "tf32x1": [("constexpr int TC_PASSES = 3;", "constexpr int TC_PASSES = 1;")],
    "one_stage": [("constexpr int TC_STAGES = 4;", "constexpr int TC_STAGES = 1;")],
    "no_promote": [("constexpr int TC_PROMOTE = 8;", "constexpr int TC_PROMOTE = 0;")],
    "loads_only": [
        ("    if constexpr (PART != 2) tc_group<0>(acc, ah0, al0, xs, bh, bl, r0, q, start);\n", ""),
        ("    if constexpr (PART == 2) tc_group<1>(acc, ah1, al1, xs, bh, bl, r0, q, start);\n", ""),
        ("    if constexpr (PART == 0) tc_group<1>(acc, ah1, al1, xs, bh, bl, r0, q, false);\n", "")],
    "compute_only": [
        ("      for (int c = 0; c < nst; ++c) tc_load(U, &tm_x, &tm_g, smem, full, empty, t0, c);\n",
         ""),
        ("      tc_split(U, smem, full, ready, nst, out);\n", ""),
        ("    mbar_wait(&full[s], (c / TC_STAGES) & 1);\n    mbar_wait(&ready[s], (c / TC_STAGES) & 1);\n",
         ""),
        ("    if (U.kind == TC_HEADS) {\n      tc_heads(U, smem, full, empty, nst, out);\n"
         "    } else if (U.kind == TC_VIEW_RGB) {\n      tc_view_rgb(U, smem, full, empty, nst, out, wg);\n"
         "    } else", "    if (U.kind == TC_HEADS || U.kind == TC_VIEW_RGB) {\n    } else")],
}
VARIANTS["stream_only"] = VARIANTS["loads_only"] + [
    ("      if (k >= nchunks) break;\n", "      break;\n")]
DIAGNOSTIC = ("loads_only", "stream_only", "compute_only")  # timing only: not the function
# variants that run the kernel's library with another unit table or launch
TABLES = {"no_fold": "kernel"}


def _time_one(name: str, so: str, n: int, reps: int, times_only: bool = False,
              split_counts=()) -> None:
    """Time one variant (in this process) and print its line."""
    import torch

    from ..ops import fused_mlp, fused_mlp_bwd as fb
    from ..train.checkpoint import load_params
    from . import f32_check

    bound = fb.bind_f32(ctypes.CDLL(so))
    fb._lib_f32 = lambda: bound  # the wrappers launch this variant
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    tree = load_params(str(variants.ROOT / "checkpoints" / "nerf" / "lego" / "nerf"))["fine"]
    kp = {k: v.to(dev) for k, v in
          fused_mlp.repack_params(tree, weight_dtype=torch.float32).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand((n, 3), generator=gen, device=dev) * 3.0 - 1.5
    dirs = torch.randn((n, 3), generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    g = torch.randn((n, 4), generator=gen, device=dev)

    def run(splits=None):
        def fn(kp, p, d, gg):
            return fb.launch_f32(kp, p, d, gg, False, splits=splits,
                                 fold_bias=name != "no_fold")["kgrads"]
        return fn

    args = list(fb.launch_f32(kp, pts, dirs, g, False, fold_bias=name != "no_fold")["args"])

    def timed(phases: int) -> float:
        args[-2] = phases
        return f32_check.time_ms(lambda: bound[0].launch_fused_nerf_bwd_f32(*args), reps)

    dw_ms = timed(4)
    whole_ms = timed(fb.F32_PHASES_ALL)
    if name == "kernel" and split_counts:
        def dw_at(s):
            a = list(fb.launch_f32(kp, pts, dirs, g, False, splits=s)["args"])
            a[-2] = 4
            return f32_check.time_ms(lambda: bound[0].launch_fused_nerf_bwd_f32(*a), reps)
        print(f"{name}: dW by point ranges: " + ", ".join(
            f"{s} {dw_at(s):.4f} ms" for s in split_counts), flush=True)
    if name in DIAGNOSTIC or times_only:
        print(f"{name}: dW {dw_ms:.4f} ms, whole {whole_ms:.4f} ms on {n} points", flush=True)
        return
    dist = f32_check.float64_distances(kp, pts, dirs, g, {"ranges": run(), "one": run(1)})
    print(f"{name}: dW {dw_ms:.4f} ms, whole {whole_ms:.4f} ms on {n} points; float64 "
          f"distance {dist['ranges'][0]:.3g} ({dist['ranges'][1]}) in "
          f"{fb.f32_splits_for(n)} ranges, {dist['one'][0]:.3g} ({dist['one'][1]}) in one; "
          f"plain float32 {dist['plain float32'][0]:.3g} ({dist['plain float32'][1]})",
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=196_608)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", default="", help="comma-separated variant names")
    ap.add_argument("--times-only", action="store_true")
    ap.add_argument("--splits", default="", help="comma-separated point-range counts")
    ap.add_argument("--one", nargs=2, metavar=("NAME", "LIB"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        _time_one(*args.one, args.points, args.reps, args.times_only,
                  [int(v) for v in args.splits.split(",") if v])
        return 0
    import torch

    if not torch.cuda.is_available():
        print("bwd_f32_variants: no CUDA device", file=sys.stderr)
        return 1
    print(variants.card(), flush=True)
    only = [n for n in args.only.split(",") if n]
    wanted = set(only or [*VARIANTS, *TABLES])
    sources = {n: v for n, v in VARIANTS.items()
               if n in wanted or n in {TABLES[t] for t in wanted if t in TABLES}}
    built = variants.build_all(MAIN, sources, OUT_DIR)
    built.update({name: built[lib] for name, lib in TABLES.items() if lib in built})
    built = {n: so for n, so in built.items() if n in wanted}
    variants.run_rounds("nerf_tpu_torch.tools.bwd_f32_variants", built,
                        ["--points", str(args.points), "--reps", str(args.reps),
                         *(["--times-only"] if args.times_only else []),
                         *(["--splits", args.splits] if args.splits else [])], timeout_s=300)
    return 0


if __name__ == "__main__":
    sys.exit(main())
