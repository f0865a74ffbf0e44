"""Alpha compositing (volume rendering integration); counterpart of ``nerf_tpu/render/composite.py``.

dists with a 1e10 tail, scaled by |rays_d|; rgb = sigmoid(raw[..., :3]);
alpha = 1 - exp(-act(sigma + noise) * dists); weights = alpha *
exclusive_cumprod(1 - alpha + 1e-10); disp = 1 / max(1e-10, depth / acc);
white background: rgb += 1 - acc. ERT zeroes the weights where the incoming
transmittance is below the threshold (T only falls, so this is the mask
``trans >= threshold``).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from .sampling import draw


def density_activation(sigma: torch.Tensor, kind: str = "relu") -> torch.Tensor:
    """raw sigma -> nonnegative density: "relu" (the NeRF MLP), "softplus"
    (the repo's hash-grid NeRF) or "exp" (Instant-NGP's network, whose
    first density output is the log of the density)."""
    if kind == "relu":
        return torch.relu(sigma)
    if kind == "softplus":
        return F.softplus(sigma)
    if kind == "exp":
        return torch.exp(sigma)
    raise ValueError(f"unknown sigma activation: {kind!r}")


# raw sigma fill for masked-out samples: exactly zero density under every
# activation (relu(-1e4) = 0; softplus(-1e4) and exp(-1e4) underflow to 0)
EMPTY_SIGMA_RAW = -1e4


def finish_maps(rgb_map, depth_map, acc_map, white_bkgd: bool) -> Dict[str, torch.Tensor]:
    """Disparity and the white background, from the weight sums."""
    disp_map = 1.0 / torch.clamp_min(depth_map / torch.clamp_min(acc_map, 1e-10), 1e-10)
    if white_bkgd:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return {"rgb_map": rgb_map, "disp_map": disp_map, "acc_map": acc_map,
            "depth_map": depth_map}


def composite(raw: torch.Tensor, z_vals: torch.Tensor, rays_d: torch.Tensor, *,
              raw_noise_std: float = 0.0, generator: Any = None,
              white_bkgd: bool = True, ert_threshold: Optional[float] = None,
              sigma_activation: str = "relu") -> Dict[str, torch.Tensor]:
    """raw: [N, S, 4] (rgb_raw, sigma_raw); z_vals: [N, S]; rays_d: [N, 3].

    Returns rgb_map [N, 3], disp_map, acc_map, depth_map [N], weights and
    transmittance [N, S].
    """
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = torch.sigmoid(raw[..., :3])
    sigma = raw[..., 3]
    if raw_noise_std > 0.0:
        sigma = sigma + draw("normal", tuple(sigma.shape), generator, sigma.dtype,
                             sigma.device) * raw_noise_std
    alpha = 1.0 - torch.exp(-density_activation(sigma, sigma_activation) * dists)
    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha[..., :-1] + 1e-10], dim=-1),
        dim=-1)
    weights = alpha * trans
    if ert_threshold is not None:
        weights = weights * (trans >= ert_threshold).to(weights.dtype)

    out = finish_maps(torch.sum(weights[..., None] * rgb, dim=-2),
                      torch.sum(weights * z_vals, dim=-1), torch.sum(weights, dim=-1),
                      white_bkgd)
    out.update(weights=weights, transmittance=trans)
    return out
