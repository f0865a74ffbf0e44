"""Rays/s scaling of the data-parallel train step; counterpart of the top-level ``bench_scaling.py``.

    python -m nerf_tpu_torch.bench_scaling [--devices N] [--rays-per-device 2048]
        [--steps 10] [--device cuda|cpu] [--out scaling_results_torch.json]

For each world in 1, 2 and N (those up to N) it starts that many ranks
(``parallel.mesh.launch``: NCCL, one rank a card, on CUDA; gloo ranks on
the CPU), each running ``make_sharded_train_step`` on JAX's small options
(8 + 16 samples, float32 weights, ERT, no ESS; 4 random 64x64 images, the
identity pose, focal 80) with a global batch of ``rays-per-device`` x world
rays: one warm step, then ``steps`` timed steps, each ended by a host read
of its loss. It prints a line a world and writes the JSON record, JAX's
(rays/s and efficiency = rays/s / (world x rays/s at world 1)) with the
card's name and power limit, to ``--out`` only (by default
``scaling_results_torch.json`` in the working directory: not the name of
the JAX package's record, so that a run from the repository's root leaves
that file as it is). On CUDA, N defaults to the visible cards; gloo ranks on
the CPU share its cores, so their efficiency only shows that every world
runs.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch


def _smi() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def rank_run(device: str, rays_per_device: int, steps: int, part: str) -> None:
    """One rank's share of one world; rank 0 writes {world, rays_per_s,
    loss} to ``part``."""
    from .config import make_cfg
    from .parallel.mesh import data_group, destroy, init_distributed
    from .parallel.multihost import is_main_process
    from .parallel.train_step import make_sharded_train_step
    from .render.renderer import RenderOptions
    from .train.loop import init_nerf_params
    from .train.optim import make_optimizer
    from .train.state import init_state

    init_distributed(device=device)
    group = data_group(device, owned=True)
    try:
        dev = group.device
        opts = RenderOptions(n_samples=8, n_importance=16, compute_dtype="float32",
                             enable_ess=False, enable_ert=True)
        tx = make_optimizer(make_cfg(None))
        rng = np.random.RandomState(0)
        n_img, H, W = 4, 64, 64
        images = torch.from_numpy(rng.randint(0, 256, (n_img, H, W, 3), np.uint8)).to(dev)
        poses = torch.eye(4).expand(n_img, 4, 4).contiguous().to(dev)
        K = torch.tensor([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1]], device=dev)
        state = init_state(init_nerf_params(torch.Generator().manual_seed(0), opts, dev), tx)
        n_rays = rays_per_device * group.world
        step = make_sharded_train_step(group, tx, opts, n_rays)
        gen = torch.Generator(device=dev).manual_seed(0)
        float(step(state, images, poses, K, gen)["loss"])  # warm: first launches
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = float(step(state, images, poses, K, gen)["loss"])
        dt = (time.perf_counter() - t0) / steps
        if is_main_process():
            with open(part, "w") as f:
                json.dump({"world": group.world, "rays_per_s": n_rays / dt, "loss": loss}, f)
    finally:
        destroy(group)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--devices", type=int, default=0,
                        help="largest world (default: the cards on CUDA, 8 on the CPU)")
    parser.add_argument("--rays-per-device", type=int, default=2048)
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--out", default="scaling_results_torch.json")
    parser.add_argument("--rank-part", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.rank_part is not None:  # one rank of a world started below
        rank_run(args.device, args.rays_per_device, args.steps, args.rank_part)
        return {}

    from .device import resolve_device
    from .parallel.mesh import launch

    dev = resolve_device(args.device)
    n_avail = args.devices or (torch.cuda.device_count() if dev.type == "cuda" else 8)
    smi = _smi() if dev.type == "cuda" else None
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for world in sorted({w for w in (1, 2, n_avail) if w <= n_avail}):
            part = os.path.join(tmp, f"world{world}.json")
            launch("nerf_tpu_torch.bench_scaling",
                   ["--device", dev.type, "--rays-per-device", str(args.rays_per_device),
                    "--steps", str(args.steps), "--rank-part", part], world, dev.type)
            with open(part) as f:
                results[world] = json.load(f)["rays_per_s"]
            eff = results[world] / (results[1] * world)
            print(f"world={world:2d}  global_batch={args.rays_per_device * world:6d}  "
                  f"{results[world]:14,.1f} rays/s  efficiency={eff * 100:6.1f}%", flush=True)
    report = {
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "backend": "nccl" if dev.type == "cuda" else "gloo",
        "device": smi,
        "rays_per_device": args.rays_per_device,
        "steps": args.steps,
        "results": {str(k): v for k, v in results.items()},
        "efficiency": {str(k): results[k] / (results[1] * k) for k in results},
    }
    if dev.type == "cpu":
        report["note"] = ("gloo ranks share one CPU: throughput cannot grow with the world, "
                          "so the efficiency here only shows that every world runs.")
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"written: {args.out}", flush=True)
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
