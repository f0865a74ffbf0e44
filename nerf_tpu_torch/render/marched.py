"""Blockwise ray marching with a transmittance carry; counterpart of ``nerf_tpu/render/marched.py``.

The fast-inference mode: ``n_blocks`` x ``block_samples`` fixed-step samples
a ray between its entry into and exit from the scene's box (rays that miss it
render pure background), no importance pass. The JAX package's ``lax.scan``
over blocks is a Python loop carrying (T, rgb, depth, acc); ERT and ESS are
masks on each block's samples, and with ``ess_compaction`` > 0 only the
masked samples are queried (``query_masked_compacted``). ``refocus`` probes
the occupancy grid at 64 points a ray and marches only the span from the
first to the last occupied probe (one probe interval of margin each side).
A block of 16,384 rays x 16 samples is 262,144 points through the fused
kernel; compositing is plain PyTorch, as in JAX, where it is XLA.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import torch

from . import occupancy as occ
from .composite import density_activation
from .rays import image_rays
from .renderer import RenderOptions, compaction_capacity, query, query_masked_compacted

N_PROBE = 64


def ray_aabb(rays_o: torch.Tensor, rays_d: torch.Tensor, bbox_min: torch.Tensor,
             bbox_max: torch.Tensor, near: float, far: float):
    """Per ray (t_enter, t_exit, hit): the box's entry and exit clamped to
    [near, far], and whether the ray meets the box ahead of its origin."""
    tiny = torch.where(rays_d < 0, -1e-10, 1e-10)
    inv = 1.0 / torch.where(rays_d.abs() < 1e-10, tiny, rays_d)
    t0 = (bbox_min - rays_o) * inv
    t1 = (bbox_max - rays_o) * inv
    t_enter = torch.minimum(t0, t1).amax(dim=-1)
    t_exit = torch.maximum(t0, t1).amin(dim=-1)
    hit = (t_exit >= t_enter) & (t_exit > 0)
    return t_enter.clamp(near, far), t_exit.clamp(near, far), hit


@torch.no_grad()
def render_rays_marched(params: Mapping[str, Any], rays_o: torch.Tensor, rays_d: torch.Tensor,
                        opts: RenderOptions, grid: Optional[occ.OccupancyGrid] = None,
                        n_blocks: int = 16, block_samples: int = 16, model: str = "fine",
                        refocus: bool = True) -> Dict[str, torch.Tensor]:
    """March [N, 3] rays; returns rgb_map [N, 3], depth_map, acc_map,
    disp_map and transmittance [N]. ``params``: {"coarse", "fine"} (the
    ``model`` one is used) or one model's weights."""
    n = rays_o.shape[0]
    dev = rays_o.device
    if grid is not None:
        bb_min, bb_max = grid.bbox_min, grid.bbox_max
    else:
        bb_min = torch.full((3,), -2.0, device=dev)
        bb_max = torch.full((3,), 2.0, device=dev)
    t_enter, t_exit, hit = ray_aabb(rays_o, rays_d, bb_min, bb_max, opts.near, opts.far)
    if refocus and grid is not None:
        tp = torch.linspace(0.0, 1.0, N_PROBE, device=dev)
        zp = t_enter[:, None] * (1.0 - tp) + t_exit[:, None] * tp
        probe = occ.query(grid, rays_o[:, None, :] + rays_d[:, None, :] * zp[..., None])
        has_occ = probe.any(dim=-1)
        big = torch.tensor(1e10, device=dev)
        pad = (t_exit - t_enter) / (N_PROBE - 1)
        z_lo = torch.where(probe, zp, big).amin(dim=-1) - pad
        z_hi = torch.where(probe, zp, -big).amax(dim=-1) + pad
        t_enter = torch.where(has_occ, torch.maximum(z_lo, t_enter), t_enter)
        t_exit = torch.where(has_occ, torch.minimum(z_hi, t_exit), t_exit)
        # ``hit`` stays: a ray whose structure slips between the probes
        # marches its whole span, and ESS still skips its empty samples
    dt = (t_exit - t_enter) / (n_blocks * block_samples)
    p = params[model] if model in params else params

    T = torch.ones(n, device=dev)
    rgb_map = torch.zeros(n, 3, device=dev)
    depth_map = torch.zeros(n, device=dev)
    acc_map = torch.zeros(n, device=dev)
    steps = torch.arange(block_samples, device=dev, dtype=torch.float32)
    for b in range(n_blocks):
        z = t_enter[:, None] + (b * block_samples + steps + 0.5) * dt[:, None]
        pts = rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]
        active = (T >= opts.ert_threshold) & hit if opts.enable_ert else hit
        mask = active[:, None].expand(n, block_samples)
        if opts.enable_ess and grid is not None:
            mask = mask & occ.query(grid, pts)
        if opts.ess_compaction > 0.0:
            cap = compaction_capacity(n * block_samples, opts.ess_compaction)
            raw = query_masked_compacted(p, pts, rays_d, opts, mask, cap)
        else:
            raw = query(p, pts, rays_d, opts)
        sigma = torch.where(mask, density_activation(raw[..., 3], opts.sigma_activation),
                            torch.zeros((), device=dev))
        rgb = torch.sigmoid(raw[..., :3])
        alpha = 1.0 - torch.exp(-sigma * dt[:, None])
        log1ma = torch.log(1.0 - alpha + 1e-10)
        excl = torch.cat([torch.zeros_like(log1ma[:, :1]),
                          torch.cumsum(log1ma[:, :-1], dim=-1)], dim=-1)
        w = alpha * T[:, None] * torch.exp(excl)
        rgb_map = rgb_map + (w[..., None] * rgb).sum(dim=1)
        depth_map = depth_map + (w * z).sum(dim=1)
        acc_map = acc_map + w.sum(dim=1)
        T = T * torch.exp(log1ma.sum(dim=-1))

    if opts.white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    disp_map = 1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)
    return {"rgb_map": rgb_map, "depth_map": depth_map, "acc_map": acc_map,
            "disp_map": disp_map, "transmittance": T}


@torch.no_grad()
def render_image_marched(params: Mapping[str, Any], pose: torch.Tensor, K: torch.Tensor,
                         H: int, W: int, opts: RenderOptions,
                         grid: Optional[occ.OccupancyGrid] = None, n_blocks: int = 16,
                         block_samples: int = 16, tile: int = 16384,
                         refocus: bool = True) -> Dict[str, torch.Tensor]:
    """An HxW image marched in tiles of ``tile`` rays (the last one ragged):
    rgb_map [H, W, 3], depth_map, acc_map, disp_map [H, W]."""
    rays_o, rays_d = image_rays(H, W, K, pose)
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    parts: Dict[str, list] = {}
    for t0 in range(0, H * W, tile):
        out = render_rays_marched(params, rays_o[t0:t0 + tile], rays_d[t0:t0 + tile], opts,
                                  grid=grid, n_blocks=n_blocks, block_samples=block_samples,
                                  refocus=refocus)
        for k, v in out.items():
            if k != "transmittance":
                parts.setdefault(k, []).append(v)
    return {k: torch.cat(v).reshape(H, W, 3) if k == "rgb_map" else torch.cat(v).reshape(H, W)
            for k, v in parts.items()}
