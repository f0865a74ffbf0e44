"""Stratified and inverse-CDF importance sampling; counterpart of ``nerf_tpu/render/sampling.py``.

``sample_pdf`` looks the samples up with ``torch.searchsorted``. It selects
the same entries as ``nerf_tpu``'s branchless masked-min/max form: for
u in [cdf[k], cdf[k+1]) "below" is entry k and "above" entry k+1, both
clamped to the ends.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample_coarse(n_rays: int, n_samples: int, near: float, far: float,
                  perturb: float = 1.0, lindisp: bool = False,
                  generator: Optional[torch.Generator] = None,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """z_vals [n_rays, n_samples]: linspace near->far (or in disparity),
    stratified when ``perturb > 0``."""
    t_vals = torch.linspace(0.0, 1.0, n_samples, device=device)
    if not lindisp:
        z_vals = near * (1.0 - t_vals) + far * t_vals
    else:
        z_vals = 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)
    z_vals = z_vals.expand(n_rays, n_samples)
    if perturb > 0.0:
        z_vals = stratify(z_vals, generator)
    return z_vals


def stratify(z_vals: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Stratified jitter within the mid-point bins of ``z_vals``."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    t_rand = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype,
                        device=z_vals.device)
    return lower + (upper - lower) * t_rand


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, n_importance: int,
               deterministic: bool, generator: Optional[torch.Generator] = None,
               u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Inverse-CDF sampling. bins [N, M] mid-point positions; weights
    [N, M-1]; ``u`` optionally overrides the positions [N, n_importance].
    Returns samples [N, n_importance]."""
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)  # [N, M]
    shape = (*cdf.shape[:-1], n_importance)
    if u is not None:
        u = torch.as_tensor(u, dtype=cdf.dtype, device=cdf.device)
    elif deterministic:
        u = torch.linspace(0.0, 1.0, n_importance, dtype=cdf.dtype,
                           device=cdf.device).expand(shape)
    else:
        u = torch.rand(shape, generator=generator, dtype=cdf.dtype, device=cdf.device)
    u = u.contiguous()
    if bins.shape[-1] < cdf.shape[-1]:  # extend by the last entry: the index clamp
        bins = torch.cat([bins, bins[..., -1:].expand(
            *bins.shape[:-1], cdf.shape[-1] - bins.shape[-1])], dim=-1)
    last = cdf.shape[-1] - 1
    idx = torch.searchsorted(cdf.contiguous(), u, right=True)
    below = torch.clamp(idx - 1, 0, last)
    above = torch.clamp(idx, 0, last)
    cdf_b, cdf_a = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bins_b, bins_a = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = cdf_a - cdf_b
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_b) / denom
    return bins_b + t * (bins_a - bins_b)
