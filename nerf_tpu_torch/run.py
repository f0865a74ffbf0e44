"""Runner CLI; counterpart of the top-level ``run.py``.

    python -m nerf_tpu_torch.run --type dataset|network|marched|evaluate \\
        --cfg_file configs/nerf/lego.yaml [--device cpu] [key value ...]

- ``dataset``: load the train split and read every item.
- ``network``: render the first 5 test views; ms per frame and rays/s with
  the first frame dropped, and the frames' kernel launches (``launches``).
- ``marched``: the first test view through the hierarchical and the marched
  renderer: seconds a frame, rays/s and PSNR of each.
- ``evaluate``: every test view through the evaluator (MSE, PSNR, SSIM,
  images, metrics JSON and summary), fps, and with ``write_video`` the
  spiral (or original) path's frames and videos; for the img_fit task
  (``task: img_fit``) the fitted view's PSNR, ``metrics.json`` and
  ``gt_pred.png``. ``ess_compaction: auto``
  is calibrated on the middle 4,096 rays of view 0.

The model comes from ``trained_model_dir`` (a missing checkpoint raises;
KiloNeRF, ``network_module: kilonerf``, from the distilled one in
``<trained_model_dir>/kilonerf``) and its ESS grid is rebuilt from its
coarse density. Runs on CUDA unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .config import make_cfg
from .data import make_dataset
from .device import resolve_device
from .eval.evaluator import Evaluator
from .eval.metrics import psnr as psnr_fn
from .ops import fused_mlp, integrate
from .render import occupancy as occ
from .render.marched import render_image_marched
from .render.rays import image_rays
from .render.renderer import (RenderOptions, kernel_params, kilo_config_from_opts,
                              make_density_fn, render_image, resolve_compaction)
from .train.checkpoint import load_kilonerf, load_params
from .utils.profiling import RaysPerSecond


def load_eval_model(cfg, device: torch.device
                    ) -> Tuple[RenderOptions, Dict, Optional[occ.OccupancyGrid]]:
    """(options, kernel weights on ``device``, ESS grid or None) of the
    checkpoint in ``cfg.trained_model_dir``; the grid is rebuilt from the
    coarse model's density (init_grid's random voxels are all overwritten).
    KiloNeRF: the distilled model of ``<trained_model_dir>/kilonerf`` for
    both passes."""
    opts = RenderOptions.from_cfg(cfg)
    if opts.kilonerf:
        p = load_kilonerf(cfg.trained_model_dir, kilo_config_from_opts(opts), device)
        params = kernel_params({"coarse": p, "fine": p}, opts, device)
    else:
        params = kernel_params(load_params(cfg.trained_model_dir, **opts.model_shape()), opts,
                               device)
    return opts, params, rebuild_grid(cfg, params, opts, device) if opts.enable_ess else None


def rebuild_grid(cfg, params, opts: RenderOptions, device) -> occ.OccupancyGrid:
    """The ESS grid of ``params``' coarse density, from ``init_grid``
    (seeded with 1) at ``occupancy_grid_resolution``."""
    gen = torch.Generator(device=device).manual_seed(1)
    return occ.populate_from_density(
        occ.init_grid(int(cfg.get("occupancy_grid_resolution", 128)), generator=gen,
                      device=device),
        make_density_fn(params["coarse"], opts))


def _tensor(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x, np.float32), device=dev)


def _seeded(dev, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def run_dataset(cfg, device=None):
    ds = make_dataset(cfg, "train")
    t0 = time.time()
    for i in range(len(ds)):
        _ = ds[i]
    print(f"dataset ok: {len(ds)} items in {time.time() - t0:.2f}s "
          f"({ds.H}x{ds.W}, focal {ds.focal:.2f})")
    return ds


def launches() -> Dict[str, int]:
    """The launch counts of the kernels a render can run (each wrapper
    counts the launches of its kernel, on CUDA tensors only)."""
    return {"fused_nerf_eval": fused_mlp.fused_nerf_eval.launches,
            "fused_nerf_eval_f32": fused_mlp.fused_nerf_eval_f32.launches,
            "integrate": integrate.integrate.launches}


def run_network(cfg, device=None) -> Dict[str, float]:
    """Render timing over the first 5 test views (frame 0 dropped); the
    last line printed is the frames' kernel launches."""
    dev = resolve_device(device)
    opts, params, grid = load_eval_model(cfg, dev)
    ds = make_dataset(cfg, "test")
    K = _tensor(ds.K, dev)
    before = launches()
    meter = RaysPerSecond(drop_first=1)
    for i in range(min(5, len(ds))):
        with meter.measure(ds.H * ds.W) as done:
            out = render_image(params, _tensor(ds.poses[i], dev), K, ds.H, ds.W, opts,
                               grid=grid, generator=_seeded(dev, i))
            done(out.get("rgb_map", out["rgb_map_0"]))
        print(f"frame {i}: {meter.samples[-1][1]:.3f}s")
    s = meter.summary()
    if s["frames"]:
        print(f"mean render time {s['mean_time_s']:.3f}s, fps {s['fps']:.2f}, "
              f"{s['rays_per_s']:,.0f} rays/s")
    print("kernel launches: " + ", ".join(f"{k} {v - before[k]}"
                                          for k, v in launches().items()))
    return s


def run_marched(cfg, device=None) -> Dict[str, Dict[str, float]]:
    """Test view 0 through the hierarchical and the marched renderer: one
    warm-up frame each, then one timed frame and its PSNR."""
    dev = resolve_device(device)
    opts, params, grid = load_eval_model(cfg, dev)
    ds = make_dataset(cfg, "test")
    K, pose = _tensor(ds.K, dev), _tensor(ds.poses[0], dev)
    n_blocks = int(cfg.get("march_blocks", 16))
    block_samples = int(cfg.get("march_block_samples", 16))
    renderers = (
        ("hierarchical", lambda g: render_image(params, pose, K, ds.H, ds.W, opts, grid=grid,
                                                generator=g)),
        ("marched", lambda g: render_image_marched(params, pose, K, ds.H, ds.W, opts, grid=grid,
                                                   n_blocks=n_blocks,
                                                   block_samples=block_samples)))
    results = {}
    for name, fn in renderers:
        fn(_seeded(dev, 0))["rgb_map"].cpu()
        meter = RaysPerSecond(drop_first=0)
        with meter.measure(ds.H * ds.W) as done:
            out = fn(_seeded(dev, 1))
            done(out["rgb_map"])
        dt = meter.samples[-1][1]
        pred = np.clip(out["rgb_map"].cpu().numpy(), 0, 1)
        p = psnr_fn(pred, ds.images[0])
        print(f"{name:>12}: {dt:6.2f}s/frame  {ds.H * ds.W / dt:>9,.0f} rays/s  psnr {p:.2f}")
        results[name] = {"seconds": dt, "rays_per_s": ds.H * ds.W / dt, "psnr": p}
    return results


def run_evaluate(cfg, device=None) -> Optional[Dict[str, float]]:
    """Every test view through the evaluator, fps, and the video path. The
    img_fit task: its view's PSNR (``eval_img_fit``)."""
    if cfg.task == "img_fit":
        from .train.img_fit_loop import eval_img_fit

        return eval_img_fit(cfg, device=device)
    dev = resolve_device(device)
    opts, params, grid = load_eval_model(cfg, dev)
    ds = make_dataset(cfg, "test")
    evaluator = Evaluator(cfg.result_dir,
                          background_strategy=cfg.get("background_strategy", "none"))
    K = _tensor(ds.K, dev)
    if opts.ess_compaction < 0.0:
        ro, rd = image_rays(ds.H, ds.W, K, _tensor(ds.poses[0], dev))
        mid = (ds.H * ds.W) // 2
        opts = resolve_compaction(opts, params, grid, ro[mid - 2048:mid + 2048].contiguous(),
                                  rd[mid - 2048:mid + 2048].contiguous(), _seeded(dev, 0))
    meter = RaysPerSecond(drop_first=1)
    for i in range(len(ds)):
        with meter.measure(ds.H * ds.W) as done:
            out = render_image(params, _tensor(ds.poses[i], dev), K, ds.H, ds.W, opts,
                               grid=grid, generator=_seeded(dev, i))
            pred = out.get("rgb_map", out["rgb_map_0"])
            done(pred)
        evaluator.evaluate(pred.cpu().numpy(), ds.images[i], i)
    summary = evaluator.summarize()
    s = meter.summary()
    if s["frames"]:
        print(f"mean net_time: {s['mean_time_s']:.3f}s  fps: {s['fps']:.2f}  "
              f"rays/s: {s['rays_per_s']:,.0f}")

    if cfg.get("write_video", False):
        from .eval.video import render_novel_view_sequence
        from .render.spiral import generate_spiral_poses

        n = int(cfg.get("render_num", 120))
        spiral = cfg.get("render_type", "spiral") == "spiral"
        poses = generate_spiral_poses(ds.poses, n) if spiral else ds.poses[:n]
        render_novel_view_sequence(frame_renderer(params, K, ds.H, ds.W, opts, grid, dev), poses,
                                   cfg.result_dir, fps=int(cfg.get("fps", 24)))
    return summary


def frame_renderer(params, K, H, W, opts, grid, dev):
    """A function pose -> {rgb_map, disp_map} as host arrays, each frame's
    jitter seeded with 0 (the video path's)."""
    def render_fn(pose):
        out = render_image(params, _tensor(pose, dev), K, H, W, opts, grid=grid,
                           generator=_seeded(dev, 0))
        return {"rgb_map": out.get("rgb_map", out["rgb_map_0"]).cpu().numpy(),
                "disp_map": out.get("disp_map", out["disp_map_0"]).cpu().numpy()}

    return render_fn


RUNS = {"dataset": run_dataset, "network": run_network, "marched": run_marched,
        "evaluate": run_evaluate}


def main(argv=None):
    parser = argparse.ArgumentParser(description="nerf_tpu_torch runner")
    parser.add_argument("--cfg_file", default=None)
    parser.add_argument("--type", default="")
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    run_fn = RUNS.get(args.type)
    if run_fn is None:
        print(f"unknown --type {args.type!r}; available: {', '.join(RUNS)}")
        sys.exit(1)
    return run_fn(make_cfg(args.cfg_file, args.opts), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
