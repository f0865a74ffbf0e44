"""KiloNeRF distillation; counterpart of ``distill_step`` in ``nerf_tpu/ops/kilonerf.py``.

The student matches the teacher's activated outputs, ``sigmoid(rgb)`` and
``log1p(relu(sigma))``, at random (point, direction) samples; the loss is
the sum of the two MSEs and the update plain Adam (``optim.plain_adam``,
optax's ``adam(lr)``). With the centres of the teacher's occupied voxels,
``occ_frac`` of the batch is drawn at jittered occupied centres and the rest
uniformly over the box, and the dispatch capacity follows the JAX
package's ``min(n_pts, max(64, 6 n_occ // n_centres))`` (a per-voxel mean
that a network holding many occupied voxels exceeds; its overflow reads as
raw 0, as in JAX). Draws come from an explicit ``torch.Generator``.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..ops.kilonerf import KiloConfig, kilonerf_eval
from ..tree import tree_leaves
from .optim import Optimizer
from .state import TrainState


def distill_capacity(n_pts: int, n_occ: int, n_centres: int) -> int:
    """The JAX package's capacity for an occupancy-weighted batch."""
    return int(min(n_pts, max(64, (6 * n_occ) // max(1, n_centres))))


def sample_batch(generator: torch.Generator, cfg: KiloConfig, n_pts: int,
                 occ_centers: Optional[torch.Tensor] = None, voxel_size: float = 0.0,
                 occ_frac: float = 0.5, device: Optional[torch.device] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """(pts [n, 3], unit dirs [n, 3], capacity; 0 = ``kilonerf_eval``'s default)."""
    lo, hi = cfg.bbox_min, cfg.bbox_max
    capacity = 0
    if occ_centers is not None and occ_centers.shape[0] > 0:
        dev = occ_centers.device
        n_occ = int(n_pts * occ_frac)
        vid = torch.randint(0, occ_centers.shape[0], (n_occ,), generator=generator, device=dev)
        jitter = (torch.rand(n_occ, 3, generator=generator, device=dev) - 0.5) * voxel_size
        uni = torch.rand(n_pts - n_occ, 3, generator=generator, device=dev) * (hi - lo) + lo
        pts = torch.cat([occ_centers[vid] + jitter, uni]).clamp(lo, hi)
        capacity = distill_capacity(n_pts, n_occ, occ_centers.shape[0])
    else:
        dev = device
        pts = torch.rand(n_pts, 3, generator=generator, device=dev) * (hi - lo) + lo
    dirs = torch.randn(n_pts, 3, generator=generator, device=pts.device)
    return pts, dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True), capacity


def teacher_targets(raw: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """raw [n, 4] -> (sigmoid(rgb) [n, 3], log1p(relu(sigma)) [n])."""
    return torch.sigmoid(raw[:, :3]), torch.log1p(torch.relu(raw[:, 3]))


def distill_loss(params, pts: torch.Tensor, dirs: torch.Tensor, t_rgb: torch.Tensor,
                 t_sigma: torch.Tensor, cfg: KiloConfig, capacity: int = 0) -> torch.Tensor:
    raw = kilonerf_eval(params, pts, dirs, cfg, capacity=capacity)
    rgb, sigma = teacher_targets(raw)
    return torch.mean((rgb - t_rgb) ** 2) + torch.mean((sigma - t_sigma) ** 2)


def distill_update(state: TrainState, tx: Optimizer, pts: torch.Tensor, dirs: torch.Tensor,
                   capacity: int, teacher_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   cfg: KiloConfig) -> torch.Tensor:
    """The step on a given batch, in place on ``state`` (params l1..l5
    requiring grad); returns the loss (a device scalar). ``teacher_fn``:
    pts [n, 1, 3], dirs [n, 3] -> raw [n, 1, 4]."""
    with torch.no_grad():
        t_rgb, t_sigma = teacher_targets(teacher_fn(pts[:, None, :], dirs)[:, 0, :].float())
    leaves = tree_leaves(state.params)
    loss = distill_loss(state.params, pts, dirs, t_rgb, t_sigma, cfg, capacity)
    grads = torch.autograd.grad(loss, leaves)
    tx.step(leaves, grads, state.opt_state)
    state.step += 1
    return loss.detach()


def distill_step(state: TrainState, tx: Optimizer, generator: torch.Generator,
                 teacher_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                 cfg: KiloConfig, n_pts: int = 65536,
                 occ_centers: Optional[torch.Tensor] = None, voxel_size: float = 0.0,
                 occ_frac: float = 0.5) -> torch.Tensor:
    """One step: ``sample_batch`` from ``generator``, then ``distill_update``."""
    pts, dirs, capacity = sample_batch(generator, cfg, n_pts, occ_centers, voxel_size, occ_frac,
                                       device=state.params["l1"]["w"].device)
    return distill_update(state, tx, pts, dirs, capacity, teacher_fn, cfg)
