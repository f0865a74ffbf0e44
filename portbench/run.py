"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It needs as many CUDA cards as the cell asks
for and fails (exit 2, no result) without them. The port's kernels build
into ``build/nerf_tpu_torch/`` of the checkout (the first run of a cell
there builds them); Triton's and PyTorch's extension caches are pointed
into ``build/portbench/`` of the checkout too.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up starts here: the imports count

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="nerf_tpu_torch benchmark: one run of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str, code: int = 2) -> None:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def cache_dirs(root: Path) -> None:
    """Build and kernel caches at fixed paths inside the checkout; one thread
    for the host's own numerical libraries (the device does the work)."""
    base = root / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"


def main(argv=None) -> None:
    args = parse_args(argv)
    cache_dirs(ROOT)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import bench, harness

    try:
        cell = bench.find_cell(args.workload, ROOT)
    except (KeyError, FileNotFoundError) as e:
        fail(str(e))
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        fail(f"{args.workload} needs {cell.chips} CUDA card(s); "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
    try:
        import nerf_tpu_torch
    except ImportError as e:
        fail(f"the program is not in this checkout: {e}")
    if Path(nerf_tpu_torch.__file__).resolve().parents[1] != ROOT:
        fail(f"nerf_tpu_torch comes from {nerf_tpu_torch.__file__}, outside {ROOT}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    ctx = harness.Context(cell=cell, seed=args.seed, seconds=args.seconds,
                          trace=bool(args.trace), device=device, t0=T0)
    outcome = bench.driver(cell.kind).run(ctx)
    found = harness.forbidden_modules()
    if found:
        fail(f"modules of JAX or the JAX package were loaded: {', '.join(found)}", 3)
    harness.emit(harness.result(ctx, outcome, torch.cuda.get_device_name(device)))


if __name__ == "__main__":
    main()
