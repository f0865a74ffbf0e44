"""Which layout of the compositing kernel (B3) wins: variants of
csrc/integrate.cu, built and timed on the GPU at every shape it runs at.

    python -m nerf_tpu_torch.tools.integrate_variants [--reps 200]

Each variant is the source with a line replaced (``VARIANTS``):
  kernel     the kernel as it is: each lane loads its ceil(S/32)
             consecutive samples at once (a ray of up to 256 samples in one
             chunk), through L1, blocks of 4 warps;
  chunk64    every ray in chunks of 64 samples (2 a lane), the next chunk's
             loads issued before this chunk's math, ERT an early exit;
  chunk32    the same in chunks of 32 samples (1 a lane);
  chunk128   the same in chunks of 128 samples (4 a lane);
  read_once  loads marked read-once (ld.global.cs) instead of through L1;
  warps2     blocks of 2 warps;
  warps8     blocks of 8 warps.
Every variant is held against the plain version (largest absolute error
over rgb, depth, acc and the weights) and timed at N x S = 8192 x 192 and
8192 x 64 (a lego serving tile, fine and coarse) and 1024 x 192 and 1024 x
64 (a hash-grid serving tile or a train batch of either model); the
kernel's line also gives the previous design (``launch_integrate_warp``,
32 samples a round, 8 warps a block) from the same library. Inputs are
random: depths sorted in [2, 6], densities 2 N(0, 1) - 3 under ReLU (most
rays stay transparent, as on the lego tiles), ERT at 0.01. Times are CUDA
events around a CUDA graph of ``--reps`` launches (so the host's launch time,
which exceeds a few-microsecond kernel's own, stays out), two rounds in opposite orders, each
variant in its own process under a timeout, on one card; the card's name
and power limit head the output. Without a GPU it exits with an error.
"""
from __future__ import annotations

import argparse
import ctypes
import sys

from ..ops import build
from . import variants

MAIN = build.CSRC / "integrate.cu"
OUT_DIR = build.BUILD_DIR / "integrate_variants"
SHAPES = ((8192, 192), (8192, 64), (1024, 192), (1024, 64))
ERT = 0.01

_CHUNKED = ("constexpr bool UP_FRONT = true;", "constexpr bool UP_FRONT = false;")
VARIANTS: variants.Variants = {
    "kernel": [],
    "chunk64": [_CHUNKED],
    "chunk32": [_CHUNKED, ("constexpr int CHUNK_K = 2;", "constexpr int CHUNK_K = 1;")],
    "chunk128": [_CHUNKED, ("constexpr int CHUNK_K = 2;", "constexpr int CHUNK_K = 4;")],
    "read_once": [("constexpr bool STREAM_LOADS = false;", "constexpr bool STREAM_LOADS = true;")],
    "warps2": [("constexpr int WARPS_PER_BLOCK = 4;", "constexpr int WARPS_PER_BLOCK = 2;")],
    "warps8": [("constexpr int WARPS_PER_BLOCK = 4;", "constexpr int WARPS_PER_BLOCK = 8;")],
}


def _inputs(n: int, s: int, dev):
    import torch

    gen = torch.Generator(device=dev).manual_seed(n + s)
    raw = torch.randn((n, s, 4), generator=gen, device=dev)
    raw[..., 3] = 2.0 * raw[..., 3] - 3.0
    z = torch.sort(torch.rand((n, s), generator=gen, device=dev) * 4.0 + 2.0, -1).values
    d = torch.randn((n, 3), generator=gen, device=dev)
    return raw, z, d / d.norm(dim=-1, keepdim=True)


def _time_one(name: str, so: str, reps: int) -> None:
    """Time one variant library (in this process) and print one line."""
    import torch

    from ..ops import integrate as tint

    lib = tint.bind(ctypes.CDLL(so))
    tint._lib = lambda: lib  # the wrappers launch this variant
    dev = torch.device("cuda")
    cells, err = [], 0.0
    for n, s in SHAPES:
        raw, z, d = _inputs(n, s, dev)
        outs = [torch.empty(shape, device=dev) for shape in ((n, 3), (n,), (n,), (n, s))]
        args = [t.data_ptr() for t in (raw, z, d, *outs)] + [n, s, ERT, 0]

        def timed(fn) -> float:
            if fn(*args, torch.cuda.current_stream().cuda_stream) != 0:
                raise RuntimeError(f"{name}: launch failed")
            return variants.graph_ms(lambda: fn(*args, torch.cuda.current_stream().cuda_stream),
                                     reps)

        cell = f"{n}x{s} {timed(lib.launch_integrate):.4f}"
        if name == "kernel":
            cell += f" (previous {timed(lib.launch_integrate_warp):.4f})"
        cells.append(cell)
        got = tint.integrate(raw, z, d, ERT, True, "relu")
        want = tint.integrate_plain(raw, z, d, ERT, True, "relu")
        err = max(err, max(float((got[k] - want[k]).abs().max())
                           for k in ("rgb_map", "depth_map", "acc_map", "weights")))
    print(f"{name}: ms at N x S: {', '.join(cells)}; max abs err against the plain version "
          f"{err:.3g}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--one", nargs=2, metavar=("NAME", "LIB"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        _time_one(*args.one, args.reps)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("integrate_variants: no CUDA device", file=sys.stderr)
        return 1
    print(variants.card(), flush=True)
    built = variants.build_all(MAIN, VARIANTS, OUT_DIR)
    variants.run_rounds("nerf_tpu_torch.tools.integrate_variants", built,
                        ["--reps", str(args.reps)])
    return 0


if __name__ == "__main__":
    sys.exit(main())
