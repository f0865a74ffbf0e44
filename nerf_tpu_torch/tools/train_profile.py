"""Where a train step's time goes on the GPU, by torch.profiler.

    python -m nerf_tpu_torch.tools.train_profile [--cfg_file FILE] [--steps 20] [--warmup 5]
        [key value ...]

With the default configs/nerf/lego.yaml it resumes the committed lego state
(checkpoints/nerf/lego/nerf, epoch 49), builds the serving path's
RenderService for its ESS grid and camera and renders 8 orbit views of the
model at 200x200 as the targets (as chip_smoke.py's phases 8-10 do). A
config without a checkpoint in its trained_model_dir (e.g.
configs/nerf/lego_hashgrid_cellpack.yaml) starts from the seed's initial
parameters, rebuilds the ESS grid from their density and takes random
colours at the same 8 poses as the targets. Then it times --steps warm
train steps (1024 rays, 64 + 128 samples) twice: once by the host clock
with a synchronize per step, once under torch.profiler. Prints ms per step,
the device's busy share (the kernels' summed time over the profiled wall
time) and the kernels and host operators that take the most time per step.
"""
from __future__ import annotations

import argparse
import math
import os
import time

import numpy as np
import torch

from ..config import make_cfg
from ..render import occupancy as occ
from ..render.renderer import RenderOptions
from ..serve import RenderService, look_at_pose
from ..train import loop
from ..train.checkpoint import load_checkpoint
from ..train.optim import make_optimizer
from ..train.state import init_state, train_step
from ..tree import tree_leaves

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total", None)
                 or getattr(evt, "self_cuda_time_total", 0.0))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--cfg_file", default=os.path.join(ROOT, "configs/nerf/lego.yaml"))
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--top", type=int, default=15)
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("train_profile measures the GPU; no CUDA device found")
    dev = torch.device("cuda")
    lego = os.path.join(ROOT, "checkpoints/nerf/lego/nerf")
    is_lego = os.path.basename(args.cfg_file) == "lego.yaml"
    cfg = make_cfg(args.cfg_file, (["trained_model_dir", lego] if is_lego else []) + args.opts)
    opts = RenderOptions.from_cfg(cfg)
    tx = make_optimizer(cfg)
    state = init_state(loop.init_nerf_params(torch.Generator().manual_seed(0), opts, dev), tx)
    thetas = [2 * math.pi * i / 8 for i in range(8)]
    poses = torch.as_tensor(np.stack([look_at_pose(t, 0.3, 4.0) for t in thetas]), device=dev)
    resumed = load_checkpoint(cfg.trained_model_dir, state)
    if resumed is not None:
        state = resumed[0]
        service = RenderService(cfg, size=200, device=dev)  # the ESS grid and the camera
        grid, K = service.grid, service.K
        imgs = torch.stack([(service.render(t, 0.3, 4.0).clamp(0, 1) * 255).round()
                            .to(torch.uint8) for t in thetas])
    else:
        gen = torch.Generator(device=dev).manual_seed(1)
        grid = occ.populate_from_density(
            occ.init_grid(int(cfg.get("occupancy_grid_resolution", 128)), generator=gen,
                          device=dev), loop.make_density_fn(state.params["coarse"], opts))
        K = torch.tensor([[278.0, 0, 100], [0, 278.0, 100], [0, 0, 1]], device=dev)
        imgs = torch.randint(0, 256, (8, 200, 200, 3), dtype=torch.uint8, device=dev,
                             generator=gen)
    print(f"{args.cfg_file}: {'resumed ' + cfg.trained_model_dir if resumed else 'initial'} "
          f"parameters, {len(tree_leaves(state.params))} leaves")
    n_rays = int(cfg.task_arg.N_rays)
    gen = torch.Generator(device=dev).manual_seed(3)

    def step():
        train_step(state, imgs, poses, K, tx, opts, n_rays, grid, gen)

    for _ in range(args.warmup):
        step()
    torch.cuda.synchronize()
    times = []
    for _ in range(args.steps):
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    w = np.array(times) * 1e3
    print(f"{torch.cuda.get_device_name(0)}: {args.steps} steps, ms per step min {w.min():.3f} "
          f"median {np.median(w):.3f} max {w.max():.3f}; {n_rays / np.median(w) * 1e3:.0f} "
          f"train rays/s at the median")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.perf_counter()
        for _ in range(args.steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    events = prof.key_averages()
    kernels = [e for e in events if _device_us(e) > 0 and e.device_type.name == "CUDA"]
    if not kernels:
        kernels = [e for e in events if _device_us(e) > 0]
    busy = sum(_device_us(e) for e in kernels) / 1e3
    print(f"profiled: {wall * 1e3 / args.steps:.3f} ms per step (wall); kernels "
          f"{busy / args.steps:.3f} ms per step, device busy {busy / (wall * 1e3):.3f} of the "
          f"wall time, idle {1 - busy / (wall * 1e3):.3f}")
    print("top kernels by device time (ms per step, launches per step):")
    for e in sorted(kernels, key=_device_us, reverse=True)[:args.top]:
        print(f"  {_device_us(e) / 1e3 / args.steps:8.4f}  {e.count / args.steps:6.1f}  "
              f"{e.key[:100]}")
    cpu = [e for e in events if e.device_type.name == "CPU"]
    print("top host operators by self CPU time (ms per step, calls per step):")
    for e in sorted(cpu, key=lambda e: e.self_cpu_time_total, reverse=True)[:args.top]:
        print(f"  {e.self_cpu_time_total / 1e3 / args.steps:8.4f}  {e.count / args.steps:6.1f}  "
              f"{e.key[:100]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
