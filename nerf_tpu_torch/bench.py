"""Benchmark: lego 800x800 rays/s, forward and train step; counterpart of the top-level ``bench.py``.

    python -m nerf_tpu_torch.bench [--f32] [--compaction <x|auto>] [--tile N] [--reps N]
                                   [--no-train] [--train-rays N] [--device cpu]

Prints one JSON line: ``metric`` (``lego_800x800_fwd_rays_per_s_per_chip``,
the JAX package's name), ``value`` (the median of ``--reps`` timed 800x800
renders after a warm-up one, through the fused MLP and integrate kernels),
``unit``, ``reps``, ``rep_spread``; unless ``--no-train``, the train step's
``train_rays_per_s`` (the median of 3 timed chunks of 50 steps of
``--train-rays`` rays after a warm-up chunk, through the fused forward, its
backward and integrate; a chunk ends when its loss is read on the host),
``train_reps``, ``train_rep_spread``; and the ``device`` it ran on.

The model is the checkpoint at the JAX package's path,
``workspace/trained_model/nerf/lego/nerf`` (relative to the working
directory; stderr says whether it was found), else ``init_nerf_params``'
weights; its ESS grid is rebuilt from the checkpoint's density. The camera
and training images are the lego test and train splits under ``LEGO_ROOT``
when they are there, else a pose at z = 4 with lego's intrinsics and two
random 800x800 images.

Not ported, each for its reason:
- ``vs_baseline`` / ``train_vs_baseline``: their denominators are rates of a TPU v5e.
- ``wait_for_tpu``: the TPU's one-process-at-a-time rule.
- ``--pallas``, ``--no-pallas-integrate``, ``--train-xla``, ``--ktile``: they choose
  TPU kernels or their tiles; the port always runs its kernels (their plain
  versions are for the tests).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Tuple

import numpy as np
import torch

from .config import default_cfg
from .data.blender import BlenderDataset
from .device import resolve_device
from .render import occupancy as occ
from .render.rays import image_rays
from .render.renderer import (RenderOptions, kernel_params, make_density_fn, render_image,
                              resolve_compaction)
from .train.checkpoint import load_params
from .train.loop import init_nerf_params
from .train.optim import make_optimizer
from .train.state import init_state, train_steps
from .tree import tree_map

LEGO_ROOT = "data/nerf_synthetic"
CKPT_DIR = os.path.join("workspace", "trained_model", "nerf", "lego", "nerf")
LEGO_FOCAL = 1111.1
SIZE = 800  # H = W of the forward frames and the training images
CHUNK_STEPS = 50  # train steps a timed chunk
GRID_RESOLUTION = 128  # the ESS grid's


def _sync(x: torch.Tensor) -> None:
    x.cpu()  # a host copy: every launch before it is done


def _spread(reps) -> float:
    return (max(reps) - min(reps)) / float(np.median(reps))


def bench_forward(params, pose: torch.Tensor, K: torch.Tensor, H: int, W: int,
                  opts: RenderOptions, grid: Optional[occ.OccupancyGrid] = None,
                  n_reps: int = 5) -> Tuple[float, list]:
    """Forward rays/s: the median of ``n_reps`` timed H x W renders after a
    warm-up one, each ended by a host copy of its colours; a fresh jitter
    seed a render. Returns (median, reps)."""
    dev = K.device
    _sync(render_image(params, pose, K, H, W, opts, grid=grid,
                       generator=torch.Generator(device=dev).manual_seed(0))["rgb_map"])
    reps = []
    for i in range(n_reps):
        t0 = time.perf_counter()
        out = render_image(params, pose, K, H, W, opts, grid=grid,
                           generator=torch.Generator(device=dev).manual_seed(i + 1))
        _sync(out["rgb_map"])
        reps.append(H * W / (time.perf_counter() - t0))
    return float(np.median(reps)), reps


def bench_train(params, images_u8: torch.Tensor, poses: torch.Tensor, K: torch.Tensor,
                opts: RenderOptions, grid: Optional[occ.OccupancyGrid], n_rays: int,
                n_steps: int = 50, n_reps: int = 3) -> Tuple[float, list]:
    """Train rays/s: the median of ``n_reps`` timed chunks of ``n_steps``
    steps (the trainer's ``train_steps``, lego's optimizer) after a warm-up
    chunk. ``params``: {"coarse", "fine"} MLP trees whose leaves require
    grad (updated in place). Returns (median, reps)."""
    tx = make_optimizer(default_cfg())
    state = init_state(params, tx)
    gen = torch.Generator(device=K.device).manual_seed(0)
    stats = train_steps(state, images_u8, poses, K, tx, opts, n_rays, n_steps, grid=grid,
                        generator=gen)
    reps = []
    for _ in range(n_reps):
        t0 = time.perf_counter()
        stats = train_steps(state, images_u8, poses, K, tx, opts, n_rays, n_steps, grid=grid,
                            generator=gen)  # returns host floats: the chunk is done
        reps.append(n_steps * n_rays / (time.perf_counter() - t0))
    if not np.isfinite(stats["loss"]):
        raise FloatingPointError(f"train loss {stats['loss']}")
    return float(np.median(reps)), reps


def lego_camera(H: int, W: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pose, K) of lego's first test view, else a pose at z = 4 with lego's focal."""
    try:
        ds = BlenderDataset(LEGO_ROOT, split="test", scene="lego", cams=[0, 2, 1], H=H, W=W)
        return (torch.as_tensor(ds.poses[0], device=dev),
                torch.as_tensor(np.asarray(ds.K, np.float32), device=dev))
    except (FileNotFoundError, IndexError):
        pose = torch.eye(4, device=dev)
        pose[2, 3] = 4.0
        K = torch.tensor([[LEGO_FOCAL, 0, W / 2], [0, LEGO_FOCAL, H / 2], [0, 0, 1]],
                         dtype=torch.float32, device=dev)
        return pose, K


def lego_train_images(H: int, W: int, dev) -> Tuple[torch.Tensor, torch.Tensor]:
    """(images uint8 [N, H, W, 3], poses [N, 4, 4]): lego's train views 0-7,
    else 2 random images at the z = 4 pose."""
    try:
        ds = BlenderDataset(LEGO_ROOT, split="train", scene="lego", cams=[0, 8, 1], H=H, W=W)
        imgs = np.round(ds.images * 255).astype(np.uint8)
        poses = np.asarray(ds.poses, np.float32)
    except (FileNotFoundError, IndexError):
        imgs = np.random.RandomState(0).randint(0, 256, (2, H, W, 3), np.uint8)
        poses = np.broadcast_to(np.eye(4, dtype=np.float32), (2, 4, 4)).copy()
        poses[:, 2, 3] = 4.0
    return torch.as_tensor(imgs, device=dev), torch.as_tensor(poses, device=dev)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="nerf_tpu_torch benchmark")
    parser.add_argument("--f32", action="store_true", help="float32 weights")
    parser.add_argument("--compaction", default=None, help="a fraction, or auto")
    parser.add_argument("--tile", type=int, default=None, help="rays per render tile")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--no-train", action="store_true")
    parser.add_argument("--train-rays", type=int, default=1024)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Run the benchmark, print its JSON line and return it."""
    args = parse_args(argv)
    H = W = SIZE
    dev = resolve_device(args.device)
    kw = {}
    if args.f32:
        kw["compute_dtype"] = "float32"
    if args.compaction is not None:
        kw["ess_compaction"] = -1.0 if args.compaction == "auto" else float(args.compaction)
    if args.tile is not None:
        kw["tile_rays"] = args.tile
    opts = RenderOptions(**kw)  # lego: 64 + 128 samples, ESS + ERT, bf16

    found = os.path.exists(os.path.join(CKPT_DIR, "latest.npz"))
    if found:
        tree = load_params(CKPT_DIR, **opts.model_shape())
        print(f"# using trained checkpoint from {CKPT_DIR}", file=sys.stderr)
    else:
        tree = tree_map(lambda t: t.detach().cpu().numpy(),
                        init_nerf_params(torch.Generator().manual_seed(0), opts))
        print(f"# no checkpoint at {CKPT_DIR}: random weights", file=sys.stderr)
    kp = kernel_params(tree, opts, dev)
    pose, K = lego_camera(H, W, dev)
    grid = None
    if opts.enable_ess:
        grid = occ.init_grid(GRID_RESOLUTION, device=dev,
                             generator=torch.Generator(device=dev).manual_seed(1))
        if found:
            grid = occ.populate_from_density(grid, make_density_fn(kp["coarse"], opts))
    if opts.ess_compaction < 0.0:
        ro, rd = image_rays(H, W, K, pose)
        mid = (H * W) // 2
        opts = resolve_compaction(opts, kp, grid, ro[mid - 2048:mid + 2048].contiguous(),
                                  rd[mid - 2048:mid + 2048].contiguous(),
                                  torch.Generator(device=dev).manual_seed(0))

    rays_per_s, reps = bench_forward(kp, pose, K, H, W, opts, grid, args.reps)
    spread = _spread(reps)
    if spread > 0.10:
        print(f"# WARNING: fwd rep spread {spread:.0%} (>10%); median reported", file=sys.stderr)
    record = {"metric": "lego_800x800_fwd_rays_per_s_per_chip", "value": round(rays_per_s, 1),
              "unit": "rays/s", "reps": [round(r, 1) for r in reps],
              "rep_spread": round(spread, 3)}
    if not args.no_train:
        images_u8, tposes = lego_train_images(H, W, dev)
        params = tree_map(lambda x: torch.as_tensor(x, device=dev).requires_grad_(True), tree)
        t_rps, t_reps = bench_train(params, images_u8, tposes, K, opts, grid, args.train_rays,
                                    n_steps=CHUNK_STEPS)
        t_spread = _spread(t_reps)
        if t_spread > 0.10:
            print(f"# WARNING: train rep spread {t_spread:.0%} (>10%); median reported",
                  file=sys.stderr)
        record.update(train_rays_per_s=round(t_rps, 1), train_reps=[round(r, 1) for r in t_reps],
                      train_rep_spread=round(t_spread, 3))
    record["device"] = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main(sys.argv[1:])
