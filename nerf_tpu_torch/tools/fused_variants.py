"""What holds the fused forward kernel back: variants of csrc/fused_mlp.cu, each
with one part of the kernel taken out or changed, built and timed on the GPU.

    python -m nerf_tpu_torch.tools.fused_variants [--points 1572864] [--reps 10]

Each variant is the kernel's source (``csrc/fused_mlp_wgmma.cuh``, which
``csrc/fused_mlp.cu`` includes) with a few lines replaced (``VARIANTS``):
  kernel       the kernel as it is;
  no_copy      the producer marks each chunk ready without copying it, so the
               products read stale weights: the cost of the L2 weight stream;
  no_epilogue  the trunk layers' epilogues removed and every product added
               onto the last, so none is dead code to ptxas: the cost of the
               epilogues, and the rate of the products, ring and encoding;
  no_turns     the two warpgroups issue their products without taking turns;
  stages3      a ring of 3 stages of 32 KB instead of 4;
  chunk32      chunks of 32 K-rows in a ring of 8 stages of 16 KB.
The variants that compute the kernel's function (kernel, no_turns, stages3,
chunk32) are held against the plain version (``fused_nerf_eval_plain``).
Each variant runs in its own process under a timeout, so a variant that
hangs costs only its own line. Times are CUDA events over ``--reps``
launches on random points, two rounds in opposite orders, on one card; the
card's name and power limit head the output. Without a GPU it exits with an error.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple

from ..ops import build

SOURCE = build.CSRC / "fused_mlp_wgmma.cuh"  # the kernel; fused_mlp.cu includes it
MAIN = build.CSRC / "fused_mlp.cu"
OUT_DIR = build.BUILD_DIR / "variants"

_EPILOGUES = """        if (l < 8) {
          trunk_epilogue<true>(d, bias + l * W, act, l == 7, wbuf + OFF_WA, s0, s1);
        } else {
          trunk_epilogue<false>(d, bias + l * W, act, false, wbuf + OFF_WA, s0, s1);
        }"""
_COPY = """      mbar_expect_tx(&full[s], bytes);
      bulk_copy(ring + s * STAGE_BYTES, reinterpret_cast<const unsigned char*>(wpack) + off,
                bytes, &full[s]);"""
_CHUNK_ASSERT = ('static_assert(NCHUNK == 39 && WPACK_SIZE == 34 * KC * W + (W + ED) * VW, '
                 '"chunk table");')
_TURN_WAIT = "    if (ch % GROUP == 0) turns.wait();"
_TURN_PASS = "      turns.pass();"

# name -> [(text of the kernel's source, its replacement)]
VARIANTS: Dict[str, List[Tuple[str, str]]] = {
    "kernel": [],
    "no_copy": [(_COPY, "      mbar_arrive(&full[s]);")],
    "no_epilogue": [(_EPILOGUES, ""),
                    ("wgmma_bf16<N>(d, da, db, ACC || ch + ks > 0);", "wgmma_bf16<N>(d, da, db, 1);")],
    "no_turns": [(_TURN_WAIT, ""), (_TURN_PASS, ""),
                 ("    if (wg == 1) named_arrive(3, 256);  // warpgroup 0 takes the first turn\n",
                  "")],
    "stages3": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;")],
    "chunk32": [("constexpr int KC = 64;", "constexpr int KC = 32;"),
                ("constexpr int STAGES = 4;", "constexpr int STAGES = 8;"), (_CHUNK_ASSERT, "")],
}
SAME_FUNCTION = ("kernel", "no_turns", "stages3", "chunk32")


def variant_source(name: str, source: str) -> str:
    """The kernel's source with the variant's replacements; raises if one of
    them no longer matches the source."""
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise ValueError(f"variant {name}: {old.splitlines()[0]!r} is not once in "
                             f"{SOURCE.name}")
        source = source.replace(old, new)
    return source


def _build_all(names) -> Dict[str, Path]:
    """Each variant's header beside a copy of fused_mlp.cu in a directory of
    its own (a quoted include looks there first), built into one library."""
    src = SOURCE.read_text()
    procs = {}
    for name in names:
        d = OUT_DIR / name
        d.mkdir(parents=True, exist_ok=True)
        (d / SOURCE.name).write_text(variant_source(name, src))
        (d / MAIN.name).write_text(MAIN.read_text())
        so = d / f"{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(so),
               str(d / MAIN.name)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    built = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate(timeout=build.NVCC_TIMEOUT_S)
        spills = [l.strip() for l in log.splitlines() if "spill" in l]
        print(f"built {name}: rc {proc.returncode}; {spills[-1] if spills else log[-300:]}",
              flush=True)
        if proc.returncode == 0:
            built[name] = so
    return built


def _time_one(name: str, so: str, n: int, reps: int) -> None:
    """Time one variant library (in this process) and print one line."""
    import torch

    from ..ops import fused_mlp
    from ..train.checkpoint import load_params

    dev = torch.device("cuda")
    root = Path(__file__).resolve().parents[2]
    tree = load_params(str(root / "checkpoints" / "nerf" / "lego" / "nerf"))["fine"]
    kp = {k: v.to(dev) for k, v in fused_mlp.repack_params(tree).items()}
    gen = torch.Generator(device=dev).manual_seed(0)
    pts = torch.rand((n, 3), generator=gen, device=dev) * 3.0 - 1.5
    dirs = torch.randn((n, 3), generator=gen, device=dev)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    lib = ctypes.CDLL(so)
    p = ctypes.c_void_p
    lib.launch_fused_nerf.argtypes = [p] * 6 + [ctypes.c_int, p]
    lib.launch_fused_nerf.restype = ctypes.c_int
    out = torch.empty((n, 4), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    args = [t.data_ptr() for t in (pts, dirs, kp["wpack"], kp["wbuf"], kp["bbuf"], out)]

    def launch():
        if lib.launch_fused_nerf(*args, n, stream) != 0:
            raise RuntimeError(f"{name}: launch failed")

    launch()
    torch.cuda.synchronize()
    agree = ""
    if name in SAME_FUNCTION:
        want = fused_mlp.fused_nerf_eval_plain(kp, pts, dirs)
        rel = ((out - want).abs() / (1.0 + want.abs())).max()
        agree = f"; max |v - plain| / (1 + |plain|) {float(rel):.3g}"
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    torch.cuda.synchronize()
    print(f"{name}: {start.elapsed_time(end) / reps:.4f} ms on {n} points{agree}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=1_572_864)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--one", nargs=2, metavar=("NAME", "LIB"), help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        _time_one(*args.one, args.points, args.reps)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("fused_variants: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    built = _build_all(VARIANTS)
    names = [n for n in VARIANTS if n in built]
    for order in (names, names[::-1]):
        for name in order:
            cmd = [sys.executable, "-m", "nerf_tpu_torch.tools.fused_variants", "--one", name,
                   str(built[name]), "--points", str(args.points), "--reps", str(args.reps)]
            try:
                r = subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                                   cwd=Path(__file__).resolve().parents[2])
                print((r.stdout.strip() or f"{name}: failed\n{r.stderr[-800:]}"), flush=True)
            except subprocess.TimeoutExpired:
                print(f"{name}: timed out (a hang)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
