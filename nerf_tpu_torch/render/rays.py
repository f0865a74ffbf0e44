"""Camera ray generation; counterpart of ``nerf_tpu/render/rays.py``.

Camera-space dirs [(i-cx)/fx, -(j-cy)/fy, -1], rotated by the c2w rotation,
origin = c2w translation, then rays_d normalized.
"""
from __future__ import annotations

import torch


def pixel_dirs(i: torch.Tensor, j: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Camera-space ray directions for pixel coords (i = x/col, j = y/row)."""
    return torch.stack([(i - K[0, 2]) / K[0, 0], -(j - K[1, 2]) / K[1, 1],
                        -torch.ones_like(i)], dim=-1)


def rays_for_pixels(i: torch.Tensor, j: torch.Tensor, K: torch.Tensor, c2w: torch.Tensor):
    """Rays for pixel coordinates i, j [...]; c2w [4,4] or [3,4], or one per
    pixel [..., 4, 4] -> (rays_o, normalized rays_d) [..., 3]."""
    dirs = pixel_dirs(i, j, K)
    rays_d = torch.sum(dirs[..., None, :] * c2w[..., :3, :3], dim=-1)
    rays_d = rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    rays_o = c2w[..., :3, 3].expand(rays_d.shape)
    return rays_o, rays_d


def image_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor):
    """All rays of an HxW image, flattened row-major to [H*W, 3]."""
    kw = dict(dtype=torch.float32, device=c2w.device)
    j, i = torch.meshgrid(torch.arange(H, **kw), torch.arange(W, **kw), indexing="ij")
    rays_o, rays_d = rays_for_pixels(i, j, K, c2w)
    return rays_o.reshape(-1, 3), rays_d.reshape(-1, 3)
