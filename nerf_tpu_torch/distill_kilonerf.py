"""KiloNeRF distillation CLI; counterpart of the top-level ``distill_kilonerf.py``.

    python -m nerf_tpu_torch.distill_kilonerf --cfg_file configs/nerf/lego.yaml \\
        [--device cpu] [kilo.steps 2000] [kilo.grid_size 16] [key value ...]

Fits the many-small-MLPs model to the NeRF teacher in ``trained_model_dir``
(a missing checkpoint raises): the ESS grid from the teacher's coarse model
(through the fused kernel on the card), occupancy-weighted samples at the
occupied voxels' centres inside the student's box, ``kilo.steps`` steps of
``kilo.n_pts`` points against the teacher's fine model (through the fused
kernel on the card, its plain version on the CPU), progress lines with
pts/s, the state saved to ``<trained_model_dir>/kilonerf``; then the student
rendered against the teacher at ``kilo.eval_size`` with
``kilo.dispatch_rounds`` rounds (compositing through the integrate kernel).
The student's box is [near - 4, far - 4]^3, as in the JAX package; the
renderer (and so the comparison render) routes in ``KiloConfig``'s
[-2, 2]^3, the same box for lego's near 2 and far 6.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys
import time

import numpy as np
import torch

from .config import make_cfg
from .device import resolve_device
from .ops.kilonerf import KiloConfig, init_kilonerf
from .render import occupancy as occ
from .render.rays import image_rays
from .render.renderer import (RenderOptions, kernel_params, make_density_fn, query,
                              render_rays)
from .train.checkpoint import KILONERF_DIR, load_params, save_checkpoint
from .train.distill import distill_step
from .train.optim import plain_adam
from .train.state import init_state


def occupied_centres(grid: occ.OccupancyGrid, kcfg: KiloConfig):
    """(centres [M, 3] of the occupied voxels inside the student's box,
    voxel size, voxels left out as outside the box)."""
    occ_np = grid.occupied.cpu().numpy()
    res = np.asarray(occ_np.shape)
    lo = grid.bbox_min.cpu().numpy().astype(np.float64).reshape(3)
    hi = grid.bbox_max.cpu().numpy().astype(np.float64).reshape(3)
    vsz = (hi - lo) / res  # per axis: the grid's box may not be a cube
    centres = lo + (np.argwhere(occ_np) + 0.5) * vsz
    inside = np.all((centres >= kcfg.bbox_min) & (centres <= kcfg.bbox_max), axis=1)
    return centres[inside], float(vsz.max()), int((~inside).sum())


def distill(cfg, device=None):
    """Distil, save, compare; returns {"losses": [(step, loss)], "pts_per_s",
    "psnr", "mse", "out_dir", "n_centres"}."""
    dev = resolve_device(device)
    opts = RenderOptions.from_cfg(cfg)
    kilo = cfg.get("kilo", {})
    kcfg = KiloConfig(grid_size=int(kilo.get("grid_size", 16)), hidden=int(kilo.get("hidden", 32)),
                      bbox_min=float(cfg.get("near", 2.0) - 4.0),
                      bbox_max=float(cfg.get("far", 6.0) - 4.0))
    steps = int(kilo.get("steps", 2000))
    n_pts = int(kilo.get("n_pts", 65536))
    lr = float(kilo.get("lr", 1e-3))
    teacher = kernel_params(load_params(cfg.trained_model_dir, **opts.model_shape()), opts, dev)

    def teacher_fn(pts, dirs):
        return query(teacher["fine"], pts, dirs, opts)

    centres, voxel_size = None, 0.0
    if bool(kilo.get("occ_sampling", True)):
        grid = occ.populate_from_density(
            occ.init_grid(int(cfg.get("occupancy_grid_resolution", 128)),
                          generator=torch.Generator(device=dev).manual_seed(1), device=dev),
            make_density_fn(teacher["coarse"], opts))
        c, voxel_size, n_out = occupied_centres(grid, kcfg)
        if len(c):
            centres = torch.as_tensor(c, dtype=torch.float32, device=dev)
        print(f"occupancy-weighted distill sampling: {len(c)} voxels "
              f"({len(c) / grid.occupied.numel():.1%}"
              f"{f', {n_out} outside student box dropped' if n_out else ''})", flush=True)

    params = init_kilonerf(torch.Generator().manual_seed(0), kcfg, dev)
    for layer in params.values():
        for t in layer.values():
            t.requires_grad_(True)
    tx = plain_adam(lr)
    state = init_state(params, tx)
    gen = torch.Generator(device=dev).manual_seed(0)
    every = max(1, steps // 20)
    losses, pts_per_s = [], 0.0
    t0 = time.perf_counter()
    for i in range(steps):
        loss = distill_step(state, tx, gen, teacher_fn, kcfg, n_pts=n_pts, occ_centers=centres,
                            voxel_size=voxel_size, occ_frac=float(kilo.get("occ_frac", 0.5)))
        if i == 0 or (i + 1) % every == 0:
            losses.append((i + 1, float(loss)))  # a host read: the steps so far are done
            pts_per_s = (i + 1) * n_pts / (time.perf_counter() - t0)
            print(f"distill step {i + 1}/{steps}  loss {losses[-1][1]:.6f}  "
                  f"({pts_per_s:,.0f} pts/s)", flush=True)

    out_dir = os.path.join(cfg.trained_model_dir, KILONERF_DIR)
    save_checkpoint(out_dir, state, epoch=0)
    print(f"distilled params saved to {out_dir}", flush=True)

    size = int(kilo.get("eval_size", 200))
    f = 1.39 * size
    pose = torch.eye(4, device=dev)
    pose[2, 3] = 4.0
    K = torch.tensor([[f, 0, size / 2], [0, f, size / 2], [0, 0, 1]], dtype=torch.float32,
                     device=dev)
    rays_o, rays_d = image_rays(size, size, K, pose)
    student_opts = dataclasses.replace(
        opts, network_type="kilonerf", kilo_grid_size=kcfg.grid_size, kilo_hidden=kcfg.hidden,
        xyz_freqs=kcfg.xyz_freqs, dir_freqs=kcfg.dir_freqs,
        kilo_dispatch_rounds=int(kilo.get("dispatch_rounds", 4)))
    box = (KiloConfig().bbox_min, KiloConfig().bbox_max)
    if (kcfg.bbox_min, kcfg.bbox_max) != box:
        print(f"note: the student's box [{kcfg.bbox_min}, {kcfg.bbox_max}] is not the "
              f"renderer's {list(box)}; the comparison routes in the renderer's, as the JAX "
              f"package's does", flush=True)
    student = {k: {n: t.detach() for n, t in v.items()} for k, v in state.params.items()}

    def render(p, o, chunk=4096):
        gen_r = torch.Generator(device=dev).manual_seed(0)
        return torch.cat([render_rays(p, rays_o[s:s + chunk].contiguous(),
                                      rays_d[s:s + chunk].contiguous(), o,
                                      generator=gen_r)["rgb_map"]
                          for s in range(0, rays_o.shape[0], chunk)])

    pt = render(teacher, opts).clamp(0, 1)
    ps = render({"coarse": student, "fine": student}, student_opts).clamp(0, 1)
    mse = float(torch.mean((pt - ps) ** 2))
    psnr = -10.0 * math.log10(max(mse, 1e-10))
    print(f"student vs teacher render: mse {mse:.6f}  psnr {psnr:.2f} dB", flush=True)
    return {"losses": losses, "pts_per_s": pts_per_s, "psnr": psnr, "mse": mse,
            "out_dir": out_dir, "n_centres": 0 if centres is None else int(centres.shape[0])}


def main(argv=None):
    parser = argparse.ArgumentParser(description="nerf_tpu_torch KiloNeRF distillation")
    parser.add_argument("--cfg_file", default=None)
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    parser.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    args = parser.parse_args(argv)
    return distill(make_cfg(args.cfg_file, args.opts), device=args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
