"""The one generator of every traffic mix: cameras, views and orbit drags.

A mix is a data file (``traffic/<mix>.json``); these functions make what it
describes from a seed, on the device where the program reads it.
"""
from __future__ import annotations

import math

import torch


def look_at(eye: torch.Tensor) -> torch.Tensor:
    """Camera-to-world [n, 4, 4] of cameras at eye [n, 3] looking at the
    origin, z up (the camera looks down its -z axis, y up)."""
    z = eye / torch.linalg.norm(eye, dim=-1, keepdim=True)
    up = torch.zeros_like(z)
    up[:, 2] = 1.0
    x = torch.linalg.cross(up, z)
    x = x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(1e-8)
    y = torch.linalg.cross(z, x)
    c2w = torch.zeros((eye.shape[0], 4, 4), dtype=torch.float32, device=eye.device)
    c2w[:, :3, 0], c2w[:, :3, 1], c2w[:, :3, 2], c2w[:, :3, 3] = x, y, z, eye
    c2w[:, 3, 3] = 1.0
    return c2w


def hemisphere_poses(n: int, radius: float, generator: torch.Generator, device,
                     max_elevation: float = 1.4) -> torch.Tensor:
    """n cameras uniform over the upper hemisphere of ``radius`` (the Blender
    scenes' train and test views), elevation below ``max_elevation``."""
    u = torch.rand((n, 2), generator=generator, device=device)
    azimuth = 2.0 * math.pi * u[:, 0]
    elevation = torch.asin(u[:, 1] * math.sin(max_elevation))
    eye = radius * torch.stack([torch.cos(elevation) * torch.cos(azimuth),
                                torch.cos(elevation) * torch.sin(azimuth),
                                torch.sin(elevation)], dim=-1)
    return look_at(eye)


def intrinsics(H: int, W: int, focal: float, device) -> torch.Tensor:
    return torch.tensor([[focal, 0.0, W / 2.0], [0.0, focal, H / 2.0], [0.0, 0.0, 1.0]],
                        dtype=torch.float32, device=device)


def synthetic_views(n: int, H: int, W: int, generator: torch.Generator, device) -> torch.Tensor:
    """n uint8 RGB views [n, H, W, 3] of uniform noise."""
    return torch.randint(0, 256, (n, H, W, 3), generator=generator, device=device,
                         dtype=torch.uint8)
