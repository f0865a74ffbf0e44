"""ESS occupancy grid; counterpart of ``nerf_tpu/render/occupancy.py``.

A bool grid [R, R, R] over the bbox [-2, 2]^3. ``populate_from_density``
rebuilds it from the model's density on a (3R)^3 lattice (3x3x3 offsets
{0, .5, 1} per cell, max-pooled, threshold 0.01), and
``sample_coarse_with_ess`` re-linspaces the coarse samples of rays that are
mostly empty into their first..last occupied z-range. ``update_from_samples``
marks the voxels of dense samples and ``decay`` clears voxels at random, so
that stale occupancy can heal.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class OccupancyGrid(NamedTuple):
    occupied: torch.Tensor  # [R, R, R] bool
    bbox_min: torch.Tensor  # [3]
    bbox_max: torch.Tensor  # [3]

    @property
    def resolution(self) -> int:
        return self.occupied.shape[0]


def init_grid(resolution: int = 128, bbox_half: float = 2.0,
              generator: Optional[torch.Generator] = None,
              device: Optional[torch.device] = None) -> OccupancyGrid:
    """Sphere (r = 1.2 in normalized [-1, 1] coords) | 10% random voxels."""
    res = resolution
    ax = torch.arange(res, dtype=torch.float32, device=device)
    coords = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1)
    coords = (coords / (res - 1)) * 2.0 - 1.0
    sphere = torch.linalg.norm(coords, dim=-1) <= 1.2
    rand = torch.rand((res, res, res), generator=generator, device=device) < 0.1
    return OccupancyGrid(
        occupied=sphere | rand,
        bbox_min=torch.full((3,), -bbox_half, dtype=torch.float32, device=device),
        bbox_max=torch.full((3,), bbox_half, dtype=torch.float32, device=device))


def full_grid(resolution: int = 128, bbox_half: float = 2.0,
              device: Optional[torch.device] = None) -> OccupancyGrid:
    """A fully occupied grid (ESS does nothing), for ablations."""
    return OccupancyGrid(
        occupied=torch.ones((resolution,) * 3, dtype=torch.bool, device=device),
        bbox_min=torch.full((3,), -bbox_half, dtype=torch.float32, device=device),
        bbox_max=torch.full((3,), bbox_half, dtype=torch.float32, device=device))


def _voxel_index(grid: OccupancyGrid, pts: torch.Tensor) -> torch.Tensor:
    res = grid.occupied.shape[0]
    x = (pts - grid.bbox_min) / (grid.bbox_max - grid.bbox_min)
    x = torch.clamp(x, 0.0, 1.0)
    return torch.clamp((x * (res - 1)).long(), 0, res - 1)


def query(grid: OccupancyGrid, pts: torch.Tensor) -> torch.Tensor:
    """pts: [..., 3] -> occupied bool [...]."""
    idx = _voxel_index(grid, pts)
    return grid.occupied[idx[..., 0], idx[..., 1], idx[..., 2]]


def update_from_samples(grid: OccupancyGrid, pts: torch.Tensor, density: torch.Tensor,
                        threshold: float = 0.01) -> OccupancyGrid:
    """Mark the voxels holding samples with density above ``threshold``."""
    res = grid.occupied.shape[0]
    idx = _voxel_index(grid, pts.reshape(-1, 3))
    flat = (idx[:, 0] * res + idx[:, 1]) * res + idx[:, 2]
    hot = (density.reshape(-1) > threshold).to(torch.uint8)
    occ = grid.occupied.to(torch.uint8).reshape(-1)
    occ = occ.scatter_reduce(0, flat, hot, reduce="amax")
    return grid._replace(occupied=occ.reshape(grid.occupied.shape).bool())


def decay(grid: OccupancyGrid, keep_prob: float = 0.99,
          generator: Optional[torch.Generator] = None,
          u: Optional[torch.Tensor] = None) -> OccupancyGrid:
    """Clear each occupied voxel with probability 1 - ``keep_prob``. ``u``
    optionally gives the uniform draws [R, R, R] (a test feeds the JAX
    package's)."""
    if u is None:
        u = torch.rand(grid.occupied.shape, generator=generator, device=grid.occupied.device)
    return grid._replace(occupied=grid.occupied & (u < keep_prob))


@torch.no_grad()
def populate_from_density(grid: OccupancyGrid,
                          density_fn: Callable[[torch.Tensor], torch.Tensor],
                          threshold: float = 0.01, chunk: int = 1 << 21) -> OccupancyGrid:
    """A cell is occupied iff any of its 27 lattice subsamples has density
    above ``threshold``. ``density_fn``: [M, 3] -> [M]. The lattice is
    evaluated in x-slabs of whole cells, at most ``chunk`` points each
    unless one cell's slab (3 * (3R)^2 points) is larger, and each slab is
    max-pooled as it comes, so memory stays bounded by the slab."""
    res = grid.occupied.shape[0]
    dev = grid.occupied.device
    cell = (grid.bbox_max - grid.bbox_min) / res
    base = torch.arange(res, dtype=torch.float32, device=dev).repeat_interleave(3)
    offs = torch.tensor([0.0, 0.5, 1.0], device=dev).repeat(res)
    ax, ay, az = (grid.bbox_min[k] + base * cell[k] + offs * cell[k] for k in range(3))
    n = 3 * res
    slab_cells = max(1, chunk // (n * n * 3))  # whole cells (3 lattice planes) per slab
    occupied = torch.empty_like(grid.occupied)
    for c0 in range(0, res, slab_cells):
        c1 = min(res, c0 + slab_cells)
        xs = ax[3 * c0: 3 * c1]
        pts = torch.stack(torch.meshgrid(xs, ay, az, indexing="ij"), dim=-1).reshape(-1, 3)
        d = density_fn(pts).reshape(c1 - c0, 3, res, 3, res, 3)
        occupied[c0:c1] = d.amax(dim=(1, 3, 5)) > threshold
    return grid._replace(occupied=occupied)


def sample_coarse_with_ess(grid: OccupancyGrid, rays_o: torch.Tensor, rays_d: torch.Tensor,
                           n_samples: int, near: float, far: float, perturb: float = 1.0,
                           lindisp: bool = False, skip_threshold: float = 0.5,
                           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Uniform probe of n_samples along each ray; rays whose empty fraction
    exceeds ``skip_threshold`` get their samples re-linspaced into the
    [first, last] occupied z-range. Returns z_vals [n_rays, n_samples]."""
    from .sampling import stratify

    n_rays = rays_o.shape[0]
    t_vals = torch.linspace(0.0, 1.0, n_samples, device=rays_o.device)
    if not lindisp:
        z_base = near * (1.0 - t_vals) + far * t_vals
    else:
        z_base = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    z_vals = z_base.expand(n_rays, n_samples)

    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    occ = query(grid, pts)
    empty_ratio = 1.0 - occ.float().mean(dim=-1)
    big = torch.tensor(1e10, dtype=z_vals.dtype, device=z_vals.device)
    z_occ_min = torch.where(occ, z_vals, big).amin(dim=-1)
    z_occ_max = torch.where(occ, z_vals, -big).amax(dim=-1)
    has_occ = occ.any(dim=-1)
    z_focus = z_occ_min[:, None] * (1.0 - t_vals) + z_occ_max[:, None] * t_vals
    refocus = (empty_ratio > skip_threshold) & has_occ
    z_vals = torch.where(refocus[:, None], z_focus, z_vals)
    if perturb > 0.0:
        z_vals = stratify(z_vals, generator)
    return z_vals
