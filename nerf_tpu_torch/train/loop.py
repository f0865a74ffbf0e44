"""The training loop; counterpart of ``nerf_tpu/train/loop.py``.

An epoch is ``ep_iter`` steps, run in chunks of ``scan_chunk`` steps whose
mean stats are checked, recorded and logged (with ``train_full_image``, one
whole-image step at a time, logged every ``log_interval`` steps and counted
as H x W rays in the rays/s line); then the ESS grid is rebuilt
from the learned density every ``grid_rebuild_ep`` epochs, starting from the
seed grid each time (a resumed run starts from the seed grid too, as the JAX
package does); checkpoints every ``save_latest_ep`` / ``save_ep`` epochs,
validation every ``eval_ep``, and a final checkpoint.

Data parallelism (``make_train_mesh``, JAX's rule): a trainer started as
ranks of a process group (``distributed: True`` under torchrun, or the ranks
that ``python -m nerf_tpu_torch.train`` starts for ``mesh_devices`` N)
splits each step's rays over them (``train_steps(..., group=)``). Rank 0
alone checkpoints, validates, records and prints, with a barrier after each
save; every rank resumes from the same checkpoint, trains rank 0's
parameters (``replicate``) and draws the same batches, and rank 0's rebuilt
ESS grid is broadcast to the others. Whole-image training
(``train_full_image``) is not split: it runs on one rank.
"""
from __future__ import annotations

import math
import os
import time
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..data import make_dataset
from ..device import resolve_device
from ..eval.metrics import psnr as psnr_fn
from ..models.hashgrid import init_hashgrid
from ..models.nerf_mlp import init_nerf_mlp
from ..models.ngp import init_ngp
from ..ops.kilonerf import init_kilonerf
from ..parallel.mesh import (DataGroup, data_group, destroy, device_count, init_distributed,
                             mesh_world, replicate)
from ..parallel.multihost import barrier, broadcast_from_main, initialized, is_main_process
from ..render import occupancy as occ
from ..render import renderer
from ..render.renderer import RenderOptions, check_weight_dtype, render_image
from ..tree import tree_leaves, tree_map
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
    one would start every density dead. KiloNeRF: one draw of
    ``init_kilonerf`` for both passes, the fine model a copy of the coarse
    one, so that the two train apart as the leaves of JAX's
    ``{"coarse": p, "fine": p}`` do (one shared tensor would be stepped
    twice, with two Adam states). Instant-NGP's network is one network,
    ``{"coarse": net}`` (``init_ngp``: its table U(+-1e-4), the paper's,
    then Xavier-uniform weights), for its one pass."""
    if opts.ngp:
        return {"coarse": init_ngp(generator, opts.ngp_shapes(), opts.hash_levels,
                                   opts.hash_features, opts.hash_log2_size,
                                   table_dtype=renderer._DTYPES[opts.hash_dtype], device=device)}
    if opts.kilonerf:
        p = init_kilonerf(generator, renderer.kilo_config_from_opts(opts), device)
        leaf = lambda t: t.detach().clone().requires_grad_(True)  # noqa: E731
        return {"coarse": tree_map(leaf, p), "fine": tree_map(leaf, p)}
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
    dev = tree_leaves(params)[0].device
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


def trainer_world(cfg, device: torch.device) -> int:
    """The world of JAX's rule for a trainer that no launcher started:
    ``mesh_world`` (the devices, capped by ``mesh_devices``, lowered until
    they divide ``N_rays``). 1 with ``train_full_image``: JAX runs the
    whole-image step unsharded, so one rank does it (N ranks would each do
    the same step)."""
    if bool(cfg.get("train_full_image", False)):
        return 1
    want = cfg.get("mesh_devices", "all")
    return mesh_world(int(cfg.task_arg.N_rays), device_count(device, want), want)


def make_train_mesh(cfg, n_rays: int, device: Optional[Union[str, torch.device]] = None
                    ) -> Optional[DataGroup]:
    """The trainer's data group, JAX's ``make_train_mesh``: ``distributed:
    True`` starts this rank's process group (``init_distributed``); under a
    process group the world is its size, which must divide ``n_rays``.
    Without one, ``trainer_world`` must come to 1, and there is no group
    (None): a larger world needs its ranks started, by torchrun or by
    ``python -m nerf_tpu_torch.train``. ``train_full_image`` trains on one
    rank with no group, and raises if started as one of several."""
    dev = resolve_device(device)
    if bool(cfg.get("train_full_image", False)):
        if max(int(os.environ.get("WORLD_SIZE", 1)),
               dist.get_world_size() if initialized() else 1) > 1:
            raise ValueError("train_full_image trains on one rank: its whole-image steps are "
                             "not split over ranks")
        return None
    created = False
    if bool(cfg.get("distributed", False)):
        created = init_distributed(device=dev, backend=cfg.get("dist_backend") or None)
    if initialized():
        group = data_group(dev, owned=created)
        if n_rays % group.world:
            destroy(group)
            raise ValueError(f"N_rays {n_rays} does not split over the {group.world} ranks")
        return group
    world = trainer_world(cfg, dev)
    if world > 1:
        raise RuntimeError(f"a data-parallel world of {world} needs its ranks: run python -m "
                           "nerf_tpu_torch.train, or torchrun with distributed True")
    return None


def train(cfg, max_epochs: Optional[int] = None,
          device: Optional[Union[str, torch.device]] = None):
    """Train ``cfg``'s NeRF; returns (state, grid). ``device`` defaults to
    CUDA (a rank of a data group uses its own card, ``cuda:LOCAL_RANK``)."""
    dev = resolve_device(device)
    opts = RenderOptions.from_cfg(cfg)
    check_weight_dtype(opts, dev)
    n_rays = int(cfg.task_arg.N_rays)
    group = make_train_mesh(cfg, n_rays, dev)
    try:
        return _train(cfg, opts, group, group.device if group else dev, max_epochs)
    finally:
        destroy(group)


def _train(cfg, opts: RenderOptions, group: Optional[DataGroup], dev: torch.device,
           max_epochs: Optional[int]):
    main = is_main_process()
    say = print if main else (lambda *a, **k: None)
    if group is not None:
        say(f"data-parallel: {group.world} ranks, {dist.get_backend()} on {dev.type}",
            flush=True)
    seed = int(cfg.get("seed", 0))
    gen_init = torch.Generator().manual_seed(seed)
    gen_grid = torch.Generator(device=dev).manual_seed(seed + 1)
    gen_train = torch.Generator(device=dev).manual_seed(seed + 2)
    n_rays = int(cfg.task_arg.N_rays)

    ds = make_dataset(cfg, "train")
    images_u8 = torch.from_numpy(np.round(ds.images * 255).astype(np.uint8)).to(dev)
    poses = torch.from_numpy(np.asarray(ds.poses, np.float32)).to(dev)
    K = torch.from_numpy(np.asarray(ds.K, np.float32)).to(dev)
    say(f"train data: {len(ds)} images {ds.H}x{ds.W} on {dev}", flush=True)

    tx = make_optimizer(cfg)
    state = init_state(init_nerf_params(gen_init, opts, dev), tx)
    seed_grid = (occ.init_grid(int(cfg.get("occupancy_grid_resolution", 128)),
                               generator=gen_grid, device=dev) if opts.enable_ess else None)
    grid = seed_grid

    model_dir = cfg.trained_model_dir
    if not cfg.get("resume", True) and main:
        wipe_dir(model_dir)
        wipe_dir(cfg.record_dir)
    barrier("wiped")
    begin_epoch = 0
    recorder = Recorder(cfg.record_dir, enabled=main)
    ckpt = load_checkpoint(model_dir, state)
    if ckpt is not None:
        state, begin_epoch, rec_state = ckpt
        begin_epoch += 1
        recorder.load_state_dict(rec_state)
        say(f"resumed from epoch {begin_epoch - 1} (step {state.step})", flush=True)
    elif cfg.get("pretrain"):
        p = str(cfg.pretrain)
        pdir, tag = ((os.path.dirname(p) or ".", os.path.basename(p)[:-4])
                     if p.endswith(".npz") else (p, "latest"))
        loaded = load_params(pdir, tag=tag, **opts.model_shape())
        with torch.no_grad():
            for dst, src in zip(tree_leaves(state.params), tree_leaves(loaded)):
                dst.copy_(torch.from_numpy(src))  # a bf16 table holds its values exactly
        say(f"initialized weights from pretrain: {p}", flush=True)
    # every rank trains rank 0's values (the seed and the checkpoint are shared already)
    replicate(group, state.params)

    ep_iter = int(cfg.get("ep_iter", 500))
    log_interval = max(1, int(cfg.get("log_interval", 10)))
    chunk = min(ep_iter, int(cfg.get("scan_chunk", max(log_interval, 50))))
    end_epoch = (int(cfg.train.epoch) if max_epochs is None
                 else min(int(cfg.train.epoch), begin_epoch + max_epochs))
    grid_rebuild_ep = int(cfg.get("grid_rebuild_ep", 10))
    precrop = (int(cfg.task_arg.get("precrop_iters", 0)),
               float(cfg.task_arg.get("precrop_frac", 0.5)))
    # whole-image steps (the reference's full-image loss): one image's H x W
    # rays a step, in tiles of render_tile_rays, as the JAX package's loop, on
    # one rank (make_train_mesh gives no group for them)
    full_image = bool(cfg.get("train_full_image", False))
    rays_per_step = ds.H * ds.W if full_image else n_rays

    def save(epoch: int) -> None:
        if main:
            save_checkpoint(model_dir, state, epoch, recorder.state_dict())
            say(f"saved checkpoint epoch {epoch} in {model_dir}", flush=True)
        barrier("saved")

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
                                         precrop_iters=precrop[0], precrop_frac=precrop[1],
                                         group=group)
            done += n
            check_finite_stats(host_stats, epoch, done)
            recorder.step = state.step
            recorder.update(host_stats)
            recorder.record("train", stats=host_stats)
            if not full_image or done % log_interval == 0 or done >= ep_iter:
                say(f"epoch {epoch} iter {done}/{ep_iter}  "
                    + "  ".join(f"{k}: {v:.4f}" for k, v in host_stats.items())
                    + f"  lr: {lr:.3e}", flush=True)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t_epoch
        say(f"epoch {epoch} done in {dt:.2f}s  ({ep_iter * rays_per_step / dt:,.0f} "
            "train rays/s)", flush=True)

        if grid is not None and (epoch + 1) % grid_rebuild_ep == 0:
            # rank 0 rebuilds; the others receive its grid into the seed's shape
            grid = (occ.populate_from_density(seed_grid,
                                              make_density_fn(state.params["coarse"], opts))
                    if main else seed_grid)
            if group is not None:
                grid = grid._replace(occupied=broadcast_from_main(grid.occupied))
            rate = float(grid.occupied.float().mean())
            say(f"occupancy grid rebuilt: {rate * 100:.2f}% occupied", flush=True)

        if (epoch + 1) % int(cfg.get("save_latest_ep", 10)) == 0:
            save(epoch)
        if (epoch + 1) % int(cfg.get("save_ep", 40)) == 0:
            save(epoch)
        if (epoch + 1) % int(cfg.get("eval_ep", 40)) == 0 and main:
            validate(cfg, state.params, opts, grid, recorder, step=state.step, device=dev)

    save(end_epoch - 1)
    recorder.close()
    say(f"training complete: epoch {end_epoch - 1}", flush=True)
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
