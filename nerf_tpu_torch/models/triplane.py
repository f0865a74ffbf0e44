"""Tri-plane factored encoder; counterpart of ``nerf_tpu/models/triplane.py``.

Three axis-aligned [R, R, F] float32 feature planes (XY, XZ, YZ), looked up
bilinearly with JAX's clamp and index order and concatenated. Plain PyTorch
indexing: the JAX package gathers them with XLA, not a Pallas kernel; the
planes' gradient is the indexing's scatter-add.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch


def init_triplane(generator: Optional[torch.Generator] = None, resolution: int = 128,
                  n_features: int = 16, init_scale: float = 1e-2,
                  device=None) -> Dict[str, torch.Tensor]:
    """{"planes": [3, R, R, F]} float32, N(0, 1) * init_scale, order (XY, XZ, YZ)."""
    planes = torch.randn((3, resolution, resolution, n_features), generator=generator)
    return {"planes": (planes * init_scale).to(device)}


def _bilinear(plane: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """plane [R, R, F], uv [N, 2] in [0, 1] -> [N, F]."""
    R = plane.shape[0]
    xy = torch.clamp(uv, 0.0, 1.0) * (R - 1)
    x0f = torch.floor(xy)
    x0 = x0f.long()
    x1 = torch.clamp(x0 + 1, max=R - 1)
    t = xy - x0f
    f00 = plane[x0[:, 0], x0[:, 1]]
    f01 = plane[x0[:, 0], x1[:, 1]]
    f10 = plane[x1[:, 0], x0[:, 1]]
    f11 = plane[x1[:, 0], x1[:, 1]]
    tx, ty = t[:, :1], t[:, 1:2]
    return (f00 * (1 - tx) * (1 - ty) + f01 * (1 - tx) * ty + f10 * tx * (1 - ty)
            + f11 * tx * ty)


def triplane_encode(params: Dict[str, torch.Tensor], pts: torch.Tensor, bbox_min: float = -2.0,
                    bbox_max: float = 2.0) -> torch.Tensor:
    """pts [N, 3] -> [N, 3F], the XY, XZ and YZ features concatenated."""
    x = (pts - bbox_min) / (bbox_max - bbox_min)
    planes = params["planes"]
    return torch.cat([_bilinear(planes[0], x[:, (0, 1)]), _bilinear(planes[1], x[:, (0, 2)]),
                      _bilinear(planes[2], x[:, (1, 2)])], dim=-1)


def triplane_out_dim(n_features: int = 16) -> int:
    return 3 * n_features
