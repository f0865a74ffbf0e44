"""D-NeRF's time-conditioned deformation field; counterpart of ``nerf_tpu/models/dnerf.py``.

x_canonical = x + MLP(freq(x) ++ freq(t)); the canonical point then feeds
any spatial encoder (frequency, hash grid, tri-plane). The head starts at
zero, so the deformation starts as the identity, and t = 0 is the canonical
frame whatever the weights. The MLP's products run in full float32
(``ops/precision.py``), as JAX's XLA dots.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..ops.precision import linear
from .encoders import freq_encode, freq_out_dim
from .nerf_mlp import linear_init


def init_deformation(generator: Optional[torch.Generator] = None, D: int = 4, W: int = 128,
                     xyz_freqs: int = 10, time_freqs: int = 4, device=None) -> Dict[str, Any]:
    """{"layers": D x {w, b} (freq(x) ++ freq(t) -> W -> ... -> W), "head":
    {w [W, 3], b [3]} zeros}."""
    dim = freq_out_dim(3, xyz_freqs) + freq_out_dim(1, time_freqs)
    layers = []
    for _ in range(D):
        layers.append(linear_init(generator, dim, W, device))
        dim = W
    head = {"w": torch.zeros((W, 3), device=device), "b": torch.zeros((3,), device=device)}
    return {"layers": layers, "head": head}


def apply_deformation(params: Dict[str, Any], pts: torch.Tensor, t, xyz_freqs: int = 10,
                      time_freqs: int = 4) -> torch.Tensor:
    """pts [N, 3], t a scalar or [N] / [N, 1] in [0, 1] -> the deformed points [N, 3]."""
    t = torch.as_tensor(t, dtype=pts.dtype, device=pts.device).reshape(-1, 1).expand(
        pts.shape[0], 1)
    h = torch.cat([freq_encode(pts, xyz_freqs), freq_encode(t, time_freqs)], dim=-1)
    for layer in params["layers"]:
        h = torch.relu(linear(h, layer))
    dx = linear(h, params["head"])
    return pts + torch.where(t > 0, dx, 0.0)


def deformed_encoder(deform_params: Dict[str, Any],
                     spatial_encode: Callable[[torch.Tensor], torch.Tensor],
                     xyz_freqs: int = 10, time_freqs: int = 4):
    """f(x, t) = spatial_encode(x + deformation(x, t))."""

    def encode(pts: torch.Tensor, t) -> torch.Tensor:
        return spatial_encode(apply_deformation(deform_params, pts, t, xyz_freqs, time_freqs))

    return encode
