"""B3, compositing (``csrc/integrate.cu``): the lower bound of one launch's
time on its inputs (the smoke test's ``integrate_bound``).

Samples up to ERT's cut (incoming transmittance at or above the threshold)
are read (raw 16 B, z 4 B, ~40 flops each); every weight (4 B a sample) and
each ray's outputs (32 B) are written. The bound is the larger of the bytes
at HBM's peak and the flops at the float32 peak. No cell reads it yet: a
traced launch's inputs are not seen (see PERF.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import peaks


def transmittance(raw: torch.Tensor, z: torch.Tensor, d: torch.Tensor, act: str) -> torch.Tensor:
    """Each sample's incoming transmittance (compositing without noise)."""
    dists = torch.cat([z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(d[..., None, :], dim=-1)
    sigma = F.softplus(raw[..., 3]) if act == "softplus" else torch.relu(raw[..., 3])
    alpha = 1.0 - torch.exp(-sigma * dists)
    return torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                    1.0 - alpha[..., :-1] + 1e-10], dim=-1), dim=-1)


def integrate_bound(raw, z, d, ert: float, act: str):
    """(bound ms, "bytes" or "operations", share of samples read)."""
    nr, s = z.shape
    read = int((transmittance(raw, z, d, act) >= ert).sum())
    nbytes = read * 20 + nr * s * 4 + nr * (12 + 12 + 4 + 4)
    flops = 40.0 * read
    bound = max(nbytes / peaks.HBM_BYTES, flops / peaks.F32_FLOPS) * 1e3
    return (bound, "bytes" if nbytes / peaks.HBM_BYTES >= flops / peaks.F32_FLOPS
            else "operations", read / (nr * s))
