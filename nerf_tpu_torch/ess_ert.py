"""ESS/ERT ablation harness; counterpart of the top-level ``test_ess_ert.py``.

    python -m nerf_tpu_torch.ess_ert --cfg_file configs/nerf/lego.yaml \\
        [--device cpu] [n_frames 3] [H 200] [W 200] [key value ...]

The checkpoint of ``trained_model_dir`` (``run.load_eval_model``; a missing
one raises) renders the first ``n_frames`` test views under the four
{ESS, ERT} configurations: seconds a frame (the first frame dropped when
there are more), rays/s and the share of rays terminated early (acc above
1 - ert_threshold); the speedups against the baseline (neither); the ESS
grid's occupancy, rebuilt from the model's density; and an ERT sweep at
0.001, 0.01 and 0.1 (ESS and ERT on), each timed on its second render.
Without the test split on disk the camera is a pose at z = 4 with focal
1.4 W at ``H`` x ``W`` (200 by default). ``H``/``W`` resize the render,
as in the JAX package. Writes ``ess_ert_results.json`` to the working
directory. Not named ``test_*.py``: it is a harness, not a test.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import numpy as np
import torch

from .config import make_cfg
from .data import make_dataset
from .device import resolve_device
from .render.renderer import render_image
from .run import load_eval_model, rebuild_grid

CONFIGS = (("baseline", False, False), ("ess_only", True, False), ("ert_only", False, True),
           ("ess_ert", True, True))
SWEEP = (0.001, 0.01, 0.1)
RESULTS = "ess_ert_results.json"


def camera(cfg, n_frames: int):
    """(poses [n, 4, 4], K [3, 3], H, W) of the first test views, else the
    synthetic camera."""
    try:
        ds = make_dataset(cfg, "test")
        poses, K, H, W = np.asarray(ds.poses[:n_frames], np.float32), ds.K, ds.H, ds.W
    except FileNotFoundError:
        print("dataset missing; using synthetic camera", flush=True)
        H = W = int(cfg.get("H", 200))
        poses = np.broadcast_to(np.eye(4, dtype=np.float32), (n_frames, 4, 4)).copy()
        poses[:, 2, 3] = 4.0
        f = 1.4 * W
        K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]], np.float32)
    return poses, np.asarray(K, np.float32), int(cfg.get("H") or H), int(cfg.get("W") or W)


def _render(params, pose, K, H, W, opts, grid, seed, dev):
    out = render_image(params, torch.as_tensor(pose, device=dev), K, H, W, opts, grid=grid,
                       generator=torch.Generator(device=dev).manual_seed(seed))
    rgb = out.get("rgb_map", out["rgb_map_0"]).cpu()  # a host copy: the frame is done
    return rgb, out.get("acc_map", out["acc_map_0"])


def ablate(cfg, device=None) -> dict:
    """Run the harness; returns what it writes to ``ess_ert_results.json``."""
    dev = resolve_device(device)
    n_frames = int(cfg.get("n_frames", 3))
    base_opts, params, grid = load_eval_model(cfg, dev)
    poses, K_np, H, W = camera(cfg, n_frames)
    K = torch.as_tensor(K_np, device=dev)
    if grid is None:  # enable_ess False in the config: the ESS rows still need it
        grid = rebuild_grid(cfg, params, base_opts, dev)
    occ_rate = float(grid.occupied.float().mean())
    print(f"occupancy grid: {grid.resolution}^3, {occ_rate * 100:.2f}% occupied", flush=True)

    thr = float(cfg.get("ert_threshold", 0.01))
    results, rays = {}, {}
    for name, ess, ert in CONFIGS:
        opts = dataclasses.replace(base_opts, enable_ess=ess, enable_ert=ert)
        times = []
        for i, pose in enumerate(poses):
            t0 = time.perf_counter()
            _, acc = _render(params, pose, K, H, W, opts, grid if ess else None, i, dev)
            times.append(time.perf_counter() - t0)
        mean_t = float(np.mean(times[1:])) if len(times) > 1 else times[0]
        results[name], rays[name] = mean_t, H * W / mean_t
        term_rate = float((acc > 1.0 - thr).float().mean()) * 100
        print(f"{name:>9}: {mean_t:.3f}s/frame  {H * W / mean_t:,.0f} rays/s  "
              f"({term_rate:.1f}% rays terminated early; per-frame: "
              f"{', '.join(f'{t:.2f}' for t in times)})", flush=True)

    print("\nspeedup vs baseline:")
    for name, t in results.items():
        print(f"  {name:>9}: {results['baseline'] / t:.2f}x")

    print("\nERT threshold sweep:")
    sweep = {}
    for t_ert in SWEEP:
        opts = dataclasses.replace(base_opts, enable_ess=True, enable_ert=True,
                                   ert_threshold=t_ert)
        _render(params, poses[0], K, H, W, opts, grid, 0, dev)
        t0 = time.perf_counter()
        _render(params, poses[0], K, H, W, opts, grid, 1, dev)
        sweep[str(t_ert)] = time.perf_counter() - t0
        print(f"  threshold {t_ert}: {sweep[str(t_ert)]:.3f}s")

    record = {"frame_times": results, "rays_per_s": rays, "occupancy_rate": occ_rate,
              "threshold_sweep": sweep, "H": H, "W": W,
              "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"}
    with open(RESULTS, "w") as f:
        json.dump(record, f, indent=2)
    print(f"\nresults written to {RESULTS}", flush=True)
    return record


def main(argv=None):
    parser = argparse.ArgumentParser(description="nerf_tpu_torch ESS/ERT ablation")
    parser.add_argument("--cfg_file", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    return ablate(make_cfg(args.cfg_file, args.opts), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
