"""Train state and the NeRF train step; counterpart of ``nerf_tpu/train/state.py``.

The images (uint8) and poses live on the device; each step draws (image,
pixel) pairs from a ``torch.Generator``, builds their rays and targets,
renders them with gradients, and applies one optimizer step. The loss is
MSE(coarse) + MSE(fine), and psnr = -10 log10(MSE(fine)).
``train_step_full_image`` renders every ray of one image instead, in tiles
whose gradients are summed before the one step.

Unlike the JAX package, which returns a new state, ``train_step`` updates
the state's parameters and optimizer moments in place (no second copy of
them on the device) and returns the step's statistics as device tensors, so
a chunk of steps syncs with the host once.

Data parallelism (``group``, a ``parallel.mesh.DataGroup``; JAX's ``mesh``):
every rank draws the same global batch, renders and differentiates its own
rows with its rows of the batch's random numbers (``RowShard``), and one
all-reduce averages the gradients and the losses before the optimizer step
(the work of ``DistributedDataParallel``, done by hand: the parameters are
dict trees, not an ``nn.Module``). The clip and Adam follow the reduction,
as JAX's psum precedes ``tx.update``, so every rank applies the same update.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..parallel.mesh import DataGroup, all_reduce_mean
from ..render.occupancy import OccupancyGrid
from ..render.rays import image_rays, rays_for_pixels
from ..render.renderer import RenderOptions, render_rays
from ..render.sampling import RowShard
from ..tree import tree_leaves
from ..utils.profiling import span
from .optim import OptState, Optimizer


@dataclasses.dataclass
class TrainState:
    params: Dict[str, Any]  # {"coarse": mlp_tree, "fine": mlp_tree}, leaves require grad
    opt_state: OptState
    step: int


def init_state(params: Dict[str, Any], tx: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=tx.init(tree_leaves(params)), step=0)


def nerf_loss(params: Dict[str, Any], rays_o: torch.Tensor, rays_d: torch.Tensor,
              target: torch.Tensor, opts: RenderOptions, grid: Optional[OccupancyGrid],
              generator: Optional[torch.Generator] = None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    out = render_rays(params, rays_o, rays_d, opts, grid=grid, generator=generator, train=True)
    loss_coarse = torch.mean((out["rgb_map_0"] - target) ** 2)
    stats = {"loss_coarse": loss_coarse}
    loss = loss_coarse
    psnr_mse = loss_coarse
    if "rgb_map" in out:
        mse_fine = torch.mean((out["rgb_map"] - target) ** 2)
        stats["loss_fine"] = mse_fine
        loss = loss + mse_fine
        psnr_mse = mse_fine
    stats["psnr"] = -10.0 * torch.log10(psnr_mse)
    stats["loss"] = loss
    return loss, stats


def sample_ray_batch(generator: Optional[torch.Generator], images_u8: torch.Tensor,
                     poses: torch.Tensor, intrinsics: torch.Tensor, n_rays: int,
                     step: Optional[int] = None, precrop_iters: int = 0,
                     precrop_frac: float = 0.5):
    """n_rays uniform (image, pixel) pairs -> rays_o, rays_d [n, 3] and the
    target colors [n, 3]. While ``step < precrop_iters`` the pixels come from
    the central ``precrop_frac`` crop. images_u8 [N, H, W, 3] uint8."""
    n_img, H, W, _ = images_u8.shape
    dev = images_u8.device

    def randint(lo, hi):
        return torch.randint(lo, hi, (n_rays,), generator=generator, device=dev)

    img_idx = randint(0, n_img)
    if precrop_iters > 0 and step is not None and step < precrop_iters:
        dH = max(1, int(H // 2 * precrop_frac))
        dW = max(1, int(W // 2 * precrop_frac))
        row, col = randint(H // 2 - dH, H // 2 + dH), randint(W // 2 - dW, W // 2 + dW)
    else:
        pix = randint(0, H * W)
        row, col = pix // W, pix % W
    target = images_u8[img_idx, row, col].float() / 255.0
    rays_o, rays_d = rays_for_pixels(col.float(), row.float(), intrinsics, poses[img_idx])
    return rays_o.contiguous(), rays_d.contiguous(), target


def loss_and_grads(params: Dict[str, Any], rays_o, rays_d, target, opts: RenderOptions,
                   grid: Optional[OccupancyGrid], generator: Optional[torch.Generator] = None
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], List[torch.Tensor]]:
    """nerf_loss and its gradient for every parameter leaf (JAX order). The
    fine MLP's leaves get zeros when ``N_importance`` is 0, as JAX's
    gradient gives them; any other leaf the loss does not reach raises."""
    loss, stats = nerf_loss(params, rays_o, rays_d, target, opts, grid, generator)
    leaves = tree_leaves(params)
    unused = ({id(p) for p in tree_leaves(params["fine"])}
              if opts.n_importance == 0 and "fine" in params else set())
    grads = iter(torch.autograd.grad(loss, [p for p in leaves if id(p) not in unused]))
    return loss.detach(), stats, [torch.zeros_like(p) if id(p) in unused else next(grads)
                                  for p in leaves]


def _global_stats(grads: List[torch.Tensor], stats: Dict[str, torch.Tensor]
                  ) -> Tuple[List[torch.Tensor], Dict[str, torch.Tensor]]:
    """The ranks' mean gradients and the global batch's losses, from one
    all-reduce: the mean of the ranks' MSEs (equal shards) is the batch's
    MSE, and the PSNR is taken from that, not averaged."""
    keys = [k for k in ("loss_coarse", "loss_fine") if k in stats]
    reduced = all_reduce_mean(list(grads) + [stats[k].detach() for k in keys])
    grads, losses = reduced[:len(grads)], dict(zip(keys, reduced[len(grads):]))
    losses["psnr"] = -10.0 * torch.log10(losses.get("loss_fine", losses["loss_coarse"]))
    losses["loss"] = sum(losses[k] for k in keys)
    return grads, {k: losses[k] for k in stats}


def apply_step(state: TrainState, rays_o: torch.Tensor, rays_d: torch.Tensor,
               target: torch.Tensor, tx: Optimizer, opts: RenderOptions,
               grid: Optional[OccupancyGrid] = None, generator: Any = None,
               group: Optional[DataGroup] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step on a batch of rays. With ``group`` the batch is
    the global one: this rank renders its rows (``group.rows``) with the
    same rows of the batch's random numbers, and the gradients and losses
    are averaged over the ranks (one all-reduce, even at world 1) before
    ``tx.step``. Updates ``state`` in place; returns the stats (tensors)."""
    if group is not None:
        rows = group.rows(rays_o.shape[0])
        generator = RowShard(generator, rows.start, rays_o.shape[0])
        rays_o, rays_d, target = rays_o[rows], rays_d[rows], target[rows]
    _, stats, grads = loss_and_grads(state.params, rays_o, rays_d, target, opts, grid, generator)
    if group is not None:
        grads, stats = _global_stats(grads, stats)
    with span("train.optimizer"):
        tx.step(tree_leaves(state.params), grads, state.opt_state)
    state.step += 1
    return {k: v.detach() for k, v in stats.items()}


@span("train.step")
def train_step(state: TrainState, images_u8: torch.Tensor, poses: torch.Tensor,
               intrinsics: torch.Tensor, tx: Optimizer, opts: RenderOptions, n_rays: int,
               grid: Optional[OccupancyGrid] = None,
               generator: Optional[torch.Generator] = None, precrop_iters: int = 0,
               precrop_frac: float = 0.5,
               group: Optional[DataGroup] = None) -> Dict[str, torch.Tensor]:
    """One step on ``n_rays`` rays drawn from ``generator`` (the global
    batch when ``group`` splits it); updates ``state`` in place and returns
    its stats (tensors)."""
    rays_o, rays_d, target = sample_ray_batch(generator, images_u8, poses, intrinsics, n_rays,
                                              step=state.step, precrop_iters=precrop_iters,
                                              precrop_frac=precrop_frac)
    return apply_step(state, rays_o, rays_d, target, tx, opts, grid, generator, group)


def train_steps(state: TrainState, images_u8, poses, intrinsics, tx: Optimizer,
                opts: RenderOptions, n_rays: int, n_steps: int,
                grid: Optional[OccupancyGrid] = None,
                generator: Optional[torch.Generator] = None, precrop_iters: int = 0,
                precrop_frac: float = 0.5,
                group: Optional[DataGroup] = None) -> Dict[str, float]:
    """``n_steps`` train steps (data-parallel over ``group``: JAX's
    ``mesh``); returns the mean of each stat over them."""
    sums: Dict[str, torch.Tensor] = {}
    for _ in range(n_steps):
        stats = train_step(state, images_u8, poses, intrinsics, tx, opts, n_rays, grid,
                           generator, precrop_iters, precrop_frac, group)
        for k, v in stats.items():
            sums[k] = sums[k] + v if k in sums else v
    return {k: float(v) / n_steps for k, v in sums.items()}


def train_step_full_image(state: TrainState, images_u8: torch.Tensor, poses: torch.Tensor,
                          intrinsics: torch.Tensor, tx: Optimizer, opts: RenderOptions, H: int,
                          W: int, tile: int = 4096, grid: Optional[OccupancyGrid] = None,
                          generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """One whole-image step, the counterpart of ``nerf_tpu``'s
    ``train_step_full_image``: one image drawn from ``generator``, all H x W
    of its rays rendered with gradients in tiles of ``tile`` rays (the last
    tile holds the rest, so no padded ray enters a sum). Each tile's sum of
    squared errors, coarse plus fine, is back-propagated and the gradients
    are summed over the tiles in each leaf's dtype; the sums divided by
    H W 3 are the gradients of the image's mean MSE, and one optimizer step
    follows. Updates ``state`` in place; returns loss, loss_coarse,
    loss_fine (0 without a fine pass) and psnr (on the fine loss when there
    is one). A tile that does not fit in device memory raises
    ``MemoryError`` with its size: the tile is the user's
    ``render_tile_rays``, not changed here."""
    dev = images_u8.device
    img = int(torch.randint(0, images_u8.shape[0], (1,), generator=generator, device=dev))
    rays_o, rays_d = image_rays(H, W, intrinsics, poses[img])
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    targets = images_u8[img].float().reshape(-1, 3) / 255.0
    leaves = tree_leaves(state.params)
    g_sum = [torch.zeros_like(leaf) for leaf in leaves]
    se_c = torch.zeros((), device=dev)
    se_f = torch.zeros((), device=dev)
    n = H * W
    for t0 in range(0, n, tile):
        sl = slice(t0, t0 + tile)
        try:
            out = render_rays(state.params, rays_o[sl], rays_d[sl], opts, grid=grid,
                              generator=generator, train=True)
            tile_c = torch.sum((out["rgb_map_0"] - targets[sl]) ** 2)
            tile_f = (torch.sum((out["rgb_map"] - targets[sl]) ** 2) if "rgb_map" in out
                      else torch.zeros_like(tile_c))
            # a model that the loss does not reach (the fine MLP without a
            # fine pass) gets zeros, as jax.grad gives
            grads = torch.autograd.grad(tile_c + tile_f, leaves, allow_unused=True,
                                        materialize_grads=True)
        except torch.cuda.OutOfMemoryError as e:
            points = min(tile, n - t0) * (opts.n_samples * 2 + opts.n_importance)
            total = torch.cuda.get_device_properties(dev).total_memory
            raise MemoryError(
                f"train_full_image: a tile of {min(tile, n - t0)} rays ({points} MLP points with "
                f"the fine pass's) does not fit in {total / 2**30:.1f} GiB of device memory "
                f"(peak {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB before it "
                "failed); set render_tile_rays lower") from e
        with torch.no_grad():
            for acc, g in zip(g_sum, grads):
                acc += g
        se_c += tile_c.detach()
        se_f += tile_f.detach()
    denom = float(n * 3)
    grads = [g / denom for g in g_sum]
    loss_coarse, loss_fine = se_c / denom, se_f / denom
    psnr_mse = torch.where(loss_fine > 0, loss_fine, loss_coarse)
    tx.step(leaves, grads, state.opt_state)
    state.step += 1
    return {"loss": loss_coarse + loss_fine, "loss_coarse": loss_coarse, "loss_fine": loss_fine,
            "psnr": -10.0 * torch.log10(psnr_mse)}
