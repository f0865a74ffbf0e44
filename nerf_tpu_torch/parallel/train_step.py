"""The data-parallel train step; counterpart of ``nerf_tpu/parallel/train_step.py``.

The reference's DDP step: render a ray batch, loss = MSE(coarse) +
MSE(fine), backward, clip at 40, Adam. JAX shards the batch over the mesh
and XLA inserts the gradient psum; here every rank draws the same global
batch and renders its rows, and ``train.state.apply_step`` averages the
gradients over the ranks in one all-reduce before the optimizer step.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..render.occupancy import OccupancyGrid
from ..render.renderer import RenderOptions
from ..train.optim import Optimizer
from ..train.state import TrainState, train_step
from .mesh import DataGroup


def make_sharded_train_step(group: Optional[DataGroup], tx: Optimizer, opts: RenderOptions,
                            n_rays: int, precrop_iters: int = 0, precrop_frac: float = 0.5
                            ) -> Callable[..., Dict[str, torch.Tensor]]:
    """Returns ``step(state, images_u8, poses, K, generator, grid)``: one step
    on a global batch of ``n_rays`` rays split over ``group`` (which must
    divide it), updating ``state`` in place and returning the batch's stats
    as tensors. (JAX's step returns a new state.)"""
    if group is not None:
        group.rows(n_rays)  # raises unless the batch splits evenly

    def step(state: TrainState, images_u8: torch.Tensor, poses: torch.Tensor,
             intrinsics: torch.Tensor, generator: Optional[torch.Generator],
             grid: Optional[OccupancyGrid] = None) -> Dict[str, torch.Tensor]:
        return train_step(state, images_u8, poses, intrinsics, tx, opts, n_rays, grid,
                          generator, precrop_iters, precrop_frac, group)

    return step
