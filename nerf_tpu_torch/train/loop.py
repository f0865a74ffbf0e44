"""The training loop; counterpart of ``nerf_tpu/train/loop.py`` (one device, no mesh).

An epoch is ``ep_iter`` steps, run in chunks of ``scan_chunk`` steps whose
mean stats are checked, recorded and logged (with ``train_full_image``, one
whole-image step at a time, logged every ``log_interval`` steps and counted
as H x W rays in the rays/s line); then the ESS grid is rebuilt
from the learned density every ``grid_rebuild_ep`` epochs, starting from the
seed grid each time (a resumed run starts from the seed grid too, as the JAX
package does); checkpoints every ``save_latest_ep`` / ``save_ep`` epochs,
validation every ``eval_ep``, and a final checkpoint.
"""
from __future__ import annotations

import math
import os
import time
from typing import Optional, Union

import numpy as np
import torch

from ..data import make_dataset
from ..device import resolve_device
from ..eval.metrics import psnr as psnr_fn
from ..models.hashgrid import init_hashgrid
from ..models.nerf_mlp import init_nerf_mlp
from ..ops.kilonerf import init_kilonerf
from ..render import occupancy as occ
from ..render import renderer
from ..render.renderer import RenderOptions, check_weight_dtype, render_image
from ..tree import tree_leaves
from .checkpoint import load_checkpoint, load_params, save_checkpoint, wipe_dir
from .optim import make_optimizer
from .recorder import Recorder
from .state import init_state, train_step_full_image, train_steps


def init_nerf_params(generator: torch.Generator, opts: RenderOptions,
                     device: Union[str, torch.device] = "cpu"):
    """{"coarse", "fine"} MLP trees of ``init_nerf_mlp``, both drawn from
    ``generator``, on ``device``. A hash-grid model then draws a table for
    each (``init_hashgrid``, U(-1e-4, 1e-4) in ``opts.hash_dtype``) and
    starts alpha_linear's bias at 0.1, as the JAX package does: the features
    start near 0, so sigma_raw is about that bias everywhere, and a negative
    one would start every density dead. KiloNeRF: one model of
    ``init_kilonerf`` for both passes, ``{"coarse": p, "fine": p}``."""
    if opts.kilonerf:
        p = init_kilonerf(generator, renderer.kilo_config_from_opts(opts), device)
        return {"coarse": p, "fine": p}
    kw = dict(D=opts.mlp_depth, W=opts.mlp_width, input_ch=opts.input_ch,
              input_ch_views=opts.input_ch_views, skips=opts.skips, device=device,
              use_viewdirs=opts.use_viewdirs)
    params = {"coarse": init_nerf_mlp(generator, **kw), "fine": init_nerf_mlp(generator, **kw)}
    if opts.hashgrid:
        for model in params.values():
            table = init_hashgrid(generator, n_levels=opts.hash_levels,
                                  n_features=opts.hash_features,
                                  log2_table_size=opts.hash_log2_size,
                                  dtype=renderer._DTYPES[opts.hash_dtype],
                                  layout=opts.hash_layout, device=device)["table"]
            model["xyz_encoder"] = {"table": table.requires_grad_(True)}
            with torch.no_grad():
                model["alpha_linear"]["b"].fill_(0.1)
    return params


def make_density_fn(params, opts: RenderOptions):
    """[M, 3] -> activated sigma of the MLP tree ``params`` (the coarse model),
    through the fused kernel (or, for a model it does not cover, the plain
    query's encodings and MLP; for KiloNeRF, its networks with no point
    dropped), for grid rebuilds."""
    dev = (params["l1"] if opts.kilonerf else params["pts_linears"][0])["w"].device
    kp = renderer.kernel_params({"m": params}, opts, dev)["m"]
    return renderer.make_density_fn(kp, opts)


def check_finite_stats(host_stats: dict, epoch: int = 0, iteration: int = 0) -> None:
    """Raise ``FloatingPointError`` on a non-finite stat (psnr may be +inf,
    where a step's MSE is exactly 0); ``--auto_restart`` resumes after it."""
    bad = {k: v for k, v in host_stats.items()
           if not math.isfinite(v) and not (k.endswith("psnr") and v > 0)}
    if bad:
        raise FloatingPointError(
            f"non-finite training stats at epoch {epoch} iter {iteration}: {bad}")


def train(cfg, max_epochs: Optional[int] = None,
          device: Optional[Union[str, torch.device]] = None):
    """Train ``cfg``'s NeRF; returns (state, grid). ``device`` defaults to CUDA."""
    dev = resolve_device(device)
    opts = RenderOptions.from_cfg(cfg)
    if opts.kilonerf:
        raise NotImplementedError("training KiloNeRF from images is not ported; distill one "
                                  "with python -m nerf_tpu_torch.distill_kilonerf")
    check_weight_dtype(opts, dev)
    seed = int(cfg.get("seed", 0))
    gen_init = torch.Generator().manual_seed(seed)
    gen_grid = torch.Generator(device=dev).manual_seed(seed + 1)
    gen_train = torch.Generator(device=dev).manual_seed(seed + 2)
    n_rays = int(cfg.task_arg.N_rays)

    ds = make_dataset(cfg, "train")
    images_u8 = torch.from_numpy(np.round(ds.images * 255).astype(np.uint8)).to(dev)
    poses = torch.from_numpy(np.asarray(ds.poses, np.float32)).to(dev)
    K = torch.from_numpy(np.asarray(ds.K, np.float32)).to(dev)
    print(f"train data: {len(ds)} images {ds.H}x{ds.W} on {dev}", flush=True)

    tx = make_optimizer(cfg)
    state = init_state(init_nerf_params(gen_init, opts, dev), tx)
    seed_grid = (occ.init_grid(int(cfg.get("occupancy_grid_resolution", 128)),
                               generator=gen_grid, device=dev) if opts.enable_ess else None)
    grid = seed_grid

    model_dir = cfg.trained_model_dir
    if not cfg.get("resume", True):
        wipe_dir(model_dir)
        wipe_dir(cfg.record_dir)
    begin_epoch = 0
    recorder = Recorder(cfg.record_dir)
    ckpt = load_checkpoint(model_dir, state)
    if ckpt is not None:
        state, begin_epoch, rec_state = ckpt
        begin_epoch += 1
        recorder.load_state_dict(rec_state)
        print(f"resumed from epoch {begin_epoch - 1} (step {state.step})", flush=True)
    elif cfg.get("pretrain"):
        p = str(cfg.pretrain)
        pdir, tag = ((os.path.dirname(p) or ".", os.path.basename(p)[:-4])
                     if p.endswith(".npz") else (p, "latest"))
        loaded = load_params(pdir, tag=tag, **opts.model_shape())
        with torch.no_grad():
            for dst, src in zip(tree_leaves(state.params), tree_leaves(loaded)):
                dst.copy_(torch.from_numpy(src))  # a bf16 table holds its values exactly
        print(f"initialized weights from pretrain: {p}", flush=True)

    ep_iter = int(cfg.get("ep_iter", 500))
    log_interval = max(1, int(cfg.get("log_interval", 10)))
    chunk = min(ep_iter, int(cfg.get("scan_chunk", max(log_interval, 50))))
    end_epoch = (int(cfg.train.epoch) if max_epochs is None
                 else min(int(cfg.train.epoch), begin_epoch + max_epochs))
    grid_rebuild_ep = int(cfg.get("grid_rebuild_ep", 10))
    precrop = (int(cfg.task_arg.get("precrop_iters", 0)),
               float(cfg.task_arg.get("precrop_frac", 0.5)))
    # whole-image steps (the reference's full-image loss): one image's H x W
    # rays a step, in tiles of render_tile_rays, as the JAX package's loop
    full_image = bool(cfg.get("train_full_image", False))
    rays_per_step = ds.H * ds.W if full_image else n_rays

    for epoch in range(begin_epoch, end_epoch):
        recorder.epoch = epoch
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_epoch = time.perf_counter()
        done = 0
        while done < ep_iter:
            lr = tx.lr(state.opt_state)
            if full_image:
                n = 1
                stats = train_step_full_image(state, images_u8, poses, K, tx, opts, ds.H, ds.W,
                                              tile=opts.tile_rays, grid=grid,
                                              generator=gen_train)
                host_stats = {k: float(v) for k, v in stats.items()}
            else:
                n = min(chunk, ep_iter - done)
                host_stats = train_steps(state, images_u8, poses, K, tx, opts, n_rays, n,
                                         grid=grid, generator=gen_train,
                                         precrop_iters=precrop[0], precrop_frac=precrop[1])
            done += n
            check_finite_stats(host_stats, epoch, done)
            recorder.step = state.step
            recorder.update(host_stats)
            recorder.record("train", stats=host_stats)
            if not full_image or done % log_interval == 0 or done >= ep_iter:
                print(f"epoch {epoch} iter {done}/{ep_iter}  "
                      + "  ".join(f"{k}: {v:.4f}" for k, v in host_stats.items())
                      + f"  lr: {lr:.3e}", flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t_epoch
        print(f"epoch {epoch} done in {dt:.2f}s  ({ep_iter * rays_per_step / dt:,.0f} "
              "train rays/s)", flush=True)

        if grid is not None and (epoch + 1) % grid_rebuild_ep == 0:
            grid = occ.populate_from_density(seed_grid,
                                             make_density_fn(state.params["coarse"], opts))
            rate = float(grid.occupied.float().mean())
            print(f"occupancy grid rebuilt: {rate * 100:.2f}% occupied", flush=True)

        if (epoch + 1) % int(cfg.get("save_latest_ep", 10)) == 0:
            save_checkpoint(model_dir, state, epoch, recorder.state_dict())
        if (epoch + 1) % int(cfg.get("save_ep", 40)) == 0:
            save_checkpoint(model_dir, state, epoch, recorder.state_dict())
        if (epoch + 1) % int(cfg.get("eval_ep", 40)) == 0:
            validate(cfg, state.params, opts, grid, recorder, step=state.step, device=dev)

    save_checkpoint(model_dir, state, end_epoch - 1, recorder.state_dict())
    recorder.close()
    print(f"training complete: epoch {end_epoch - 1}", flush=True)
    return state, grid


def validate(cfg, params, opts: RenderOptions, grid, recorder=None, step: int = 0,
             n_images: int = 2, device: Union[str, torch.device] = "cpu"):
    """Render a couple of val images and log their PSNR. Without the val
    split on disk it warns and skips, as the JAX package does, so that a
    wrong data_root does not train with no sign that validation never ran."""
    val_cfg = cfg.clone()
    val_cfg.test_dataset.split = "val"
    try:
        ds = make_dataset(val_cfg, "test")
    except FileNotFoundError as e:
        print(f"WARNING: val split not available ({e}); skipping validation", flush=True)
        return None
    dev = torch.device(device)
    kp = renderer.kernel_params(params, opts, dev)
    K = torch.from_numpy(np.asarray(ds.K, np.float32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    psnrs = []
    for i in range(min(n_images, len(ds))):
        pose = torch.from_numpy(np.asarray(ds.poses[i], np.float32)).to(dev)
        out = render_image(kp, pose, K, ds.H, ds.W, opts, grid=grid, generator=gen)
        pred = out.get("rgb_map", out["rgb_map_0"]).cpu().numpy()
        psnrs.append(psnr_fn(np.clip(pred, 0, 1), ds.images[i]))
    mean_psnr = float(np.mean(psnrs))
    print(f"val psnr: {mean_psnr:.2f}", flush=True)
    if recorder is not None:
        recorder.record("val", step=step, stats={"psnr": mean_psnr})
    return mean_psnr
