"""Hash-grid encoders for dynamic scenes; counterpart of ``nerf_tpu/models/hash_variants.py``.

- ``hash4d``: one 4-D (xyzt) grid, the time rescaled into the bbox.
- ``hash_latent``: the 3-D grid's features ++ a per-frame latent code.
- ``hash_coef``: a softmax blend of ``basis_num`` 3-D grids, the weights
  from a 4-D grid through a two-layer MLP.
- ``motion2d``: a sigmoid deformation MLP on (x, t), then three 2-D grids on
  the coordinate pairs (0, 1), (1, 2), (0, 2) of the deformed point (bbox
  [0, 1]); no deformation at t = 0.

The grids are the port's ``hashgrid_encode`` in the corner layout with
bfloat16 tables (JAX's ``init_hashgrid`` defaults): on CUDA tensors each
lookup is one B4 gather of 2^D rows a point and level, and its gradient one
B4' scatter-add; ``plain=True`` takes the plain versions. The MLPs' products
run in full float32 (``ops/precision.py``), as JAX's XLA dots.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops.precision import linear
from .hashgrid import hashgrid_encode, hashgrid_out_dim, init_hashgrid
from .nerf_mlp import linear_init


def _norm_time(xyzt: torch.Tensor, num_frames: int) -> torch.Tensor:
    """xyzt[..., 3] is a frame index; normalised to [0, 1]."""
    t = xyzt[..., 3:] / float(max(num_frames - 1, 1))
    return torch.cat([xyzt[..., :3], t], dim=-1)


def init_hash4d(generator: Optional[torch.Generator] = None, num_frames: int = 60,
                **kwargs) -> Dict:
    return {"grid": init_hashgrid(generator, **kwargs)}


def hash4d_encode(params: Dict, xyzt: torch.Tensor, num_frames: int = 60,
                  base_resolution: int = 16, per_level_scale: float = 1.3819,
                  bbox_min: float = -2.0, bbox_max: float = 2.0,
                  plain: bool = False) -> torch.Tensor:
    x = _norm_time(xyzt, num_frames)
    xt = torch.cat([x[..., :3], x[..., 3:] * (bbox_max - bbox_min) + bbox_min], dim=-1)
    return hashgrid_encode(params["grid"], xt, base_resolution=base_resolution,
                           per_level_scale=per_level_scale, bbox_min=bbox_min,
                           bbox_max=bbox_max, plain=plain)


def init_hash_latent(generator: Optional[torch.Generator] = None, num_frames: int = 60,
                     latent_dim: int = 32, device=None, **kwargs) -> Dict:
    grid = init_hashgrid(generator, device=device, **kwargs)
    latent = torch.empty((num_frames, latent_dim)).uniform_(-1e-4, 1e-4, generator=generator)
    return {"grid": grid, "latent_t": latent.to(device)}


def hash_latent_encode(params: Dict, xyzt: torch.Tensor, base_resolution: int = 16,
                       per_level_scale: float = 1.3819, plain: bool = False) -> torch.Tensor:
    xyz_feat = hashgrid_encode(params["grid"], xyzt[..., :3], base_resolution=base_resolution,
                               per_level_scale=per_level_scale, plain=plain)
    latent = params["latent_t"]
    t_idx = torch.clamp(xyzt[..., 3].to(torch.int64), 0, latent.shape[0] - 1)
    return torch.cat([xyz_feat, latent[t_idx]], dim=-1)


def init_hash_coef(generator: Optional[torch.Generator] = None, basis_num: int = 6,
                   coef_hidden: int = 64, device=None, **kwargs) -> Dict:
    bases = [init_hashgrid(generator, device=device, **kwargs) for _ in range(basis_num)]
    coef_grid = init_hashgrid(generator, device=device, **kwargs)
    in_dim = hashgrid_out_dim(kwargs.get("n_levels", 16), kwargs.get("n_features", 2))
    return {"bases": bases, "coef_grid": coef_grid,
            "coef_l1": linear_init(generator, in_dim, coef_hidden, device),
            "coef_l2": linear_init(generator, coef_hidden, basis_num, device)}


def hash_coef_encode(params: Dict, xyzt: torch.Tensor, num_frames: int = 60,
                     base_resolution: int = 16, per_level_scale: float = 1.3819,
                     plain: bool = False) -> torch.Tensor:
    kw = dict(base_resolution=base_resolution, per_level_scale=per_level_scale, plain=plain)
    xt = _norm_time(xyzt, num_frames)
    xt4 = torch.cat([xt[..., :3], xt[..., 3:] * 4.0 - 2.0], dim=-1)
    coef_emb = hashgrid_encode(params["coef_grid"], xt4, **kw)
    h = torch.relu(linear(coef_emb, params["coef_l1"]))
    coefs = torch.softmax(linear(h, params["coef_l2"]), dim=-1)  # [N, B]
    embs = torch.stack([hashgrid_encode(b, xyzt[..., :3], **kw) for b in params["bases"]],
                       dim=1)  # [N, B, L*F]
    return torch.sum(embs * coefs[..., None], dim=1)


def init_motion2d(generator: Optional[torch.Generator] = None, mlp_width: int = 128,
                  mlp_depth: int = 7, device=None, **kwargs) -> Dict:
    planes = [init_hashgrid(generator, device=device, **kwargs) for _ in range(3)]
    layers, dim = [], 4
    for _ in range(mlp_depth):
        layers.append(linear_init(generator, dim, mlp_width, device))
        dim = mlp_width
    return {"planes": planes, "mlp": layers,
            "head": linear_init(generator, mlp_width, 3, device)}


MOTION_PAIRS = ((0, 1), (1, 2), (0, 2))


def motion2d_encode(params: Dict, xyzt: torch.Tensor, num_frames: int = 60,
                    base_resolution: int = 16, per_level_scale: float = 1.3819,
                    bbox_min: float = -2.0, bbox_max: float = 2.0,
                    plain: bool = False) -> torch.Tensor:
    x = torch.clamp(xyzt[..., :3], bbox_min, bbox_max)
    x = (x - bbox_min) / (bbox_max - bbox_min)  # [0, 1]
    t = xyzt[..., 3:] / float(max(num_frames - 1, 1))
    h = torch.cat([x, t], dim=-1)
    for layer in params["mlp"]:
        h = torch.relu(linear(h, layer))
    delta = torch.sigmoid(linear(h, params["head"]))
    xyz_def = torch.clamp(x + 2.0 * delta - 1.0, 0.0, 1.0)
    xyz_use = torch.where(t > 0, xyz_def, x)  # t = 0, the canonical frame: no deformation
    return torch.cat([
        hashgrid_encode(params["planes"][i], xyz_use[..., list(p)],
                        base_resolution=base_resolution, per_level_scale=per_level_scale,
                        bbox_min=0.0, bbox_max=1.0, plain=plain)
        for i, p in enumerate(MOTION_PAIRS)], dim=-1)
