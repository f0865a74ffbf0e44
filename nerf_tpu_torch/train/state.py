"""Train state and the NeRF train step; counterpart of ``nerf_tpu/train/state.py``.

The images (uint8) and poses live on the device; each step draws (image,
pixel) pairs from a ``torch.Generator``, builds their rays and targets,
renders them with gradients, and applies one optimizer step. The loss is
MSE(coarse) + MSE(fine), and psnr = -10 log10(MSE(fine)).

Unlike the JAX package, which returns a new state, ``train_step`` updates
the state's parameters and optimizer moments in place (no second copy of
them on the device) and returns the step's statistics as device tensors, so
a chunk of steps syncs with the host once.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from ..render.occupancy import OccupancyGrid
from ..render.rays import rays_for_pixels
from ..render.renderer import RenderOptions, render_rays
from ..tree import tree_leaves
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
    """nerf_loss and its gradient for every parameter leaf (JAX order)."""
    loss, stats = nerf_loss(params, rays_o, rays_d, target, opts, grid, generator)
    grads = torch.autograd.grad(loss, tree_leaves(params))
    return loss.detach(), stats, list(grads)


def train_step(state: TrainState, images_u8: torch.Tensor, poses: torch.Tensor,
               intrinsics: torch.Tensor, tx: Optimizer, opts: RenderOptions, n_rays: int,
               grid: Optional[OccupancyGrid] = None,
               generator: Optional[torch.Generator] = None, precrop_iters: int = 0,
               precrop_frac: float = 0.5) -> Dict[str, torch.Tensor]:
    """One step; updates ``state`` in place and returns its stats (tensors)."""
    rays_o, rays_d, target = sample_ray_batch(generator, images_u8, poses, intrinsics, n_rays,
                                              step=state.step, precrop_iters=precrop_iters,
                                              precrop_frac=precrop_frac)
    _, stats, grads = loss_and_grads(state.params, rays_o, rays_d, target, opts, grid,
                                     generator)
    tx.step(tree_leaves(state.params), grads, state.opt_state)
    state.step += 1
    return {k: v.detach() for k, v in stats.items()}


def train_steps(state: TrainState, images_u8, poses, intrinsics, tx: Optimizer,
                opts: RenderOptions, n_rays: int, n_steps: int,
                grid: Optional[OccupancyGrid] = None,
                generator: Optional[torch.Generator] = None, precrop_iters: int = 0,
                precrop_frac: float = 0.5) -> Dict[str, float]:
    """``n_steps`` train steps; returns the mean of each stat over them."""
    sums: Dict[str, torch.Tensor] = {}
    for _ in range(n_steps):
        stats = train_step(state, images_u8, poses, intrinsics, tx, opts, n_rays, grid,
                           generator, precrop_iters, precrop_frac)
        for k, v in stats.items():
            sums[k] = sums[k] + v if k in sums else v
    return {k: float(v) / n_steps for k, v in sums.items()}
