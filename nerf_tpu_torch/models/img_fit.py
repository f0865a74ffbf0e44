"""img_fit: the 2D image regression MLP; counterpart of ``nerf_tpu/models/img_fit.py``.

uv [.., 2] frequency-encoded with 10 bands (42 channels) -> D x W ReLU
(4 x 128) -> sigmoid RGB. The products run in full float32
(``ops/precision.py``), as JAX's XLA dots: the JAX package runs this MLP
outside any Pallas kernel.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..ops.precision import linear
from .encoders import freq_encode, freq_out_dim
from .nerf_mlp import linear_init


def init_img_fit_mlp(generator: Optional[torch.Generator] = None, D: int = 4, W: int = 128,
                     input_dim: int = 2, num_freqs: int = 10, device=None) -> Dict[str, Any]:
    """{"layers": D x {w [in, W], b [W]}, "head": {w [W, 3], b [3]}}, float32."""
    layers, dim = [], freq_out_dim(input_dim, num_freqs)
    for _ in range(D):
        layers.append(linear_init(generator, dim, W, device))
        dim = W
    return {"layers": layers, "head": linear_init(generator, W, 3, device)}


def apply_img_fit_mlp(params: Dict[str, Any], uv: torch.Tensor,
                      num_freqs: int = 10) -> torch.Tensor:
    """uv [..., 2] in [0, 1]^2 -> rgb [..., 3] in (0, 1)."""
    h = freq_encode(uv, num_freqs)
    for layer in params["layers"]:
        h = torch.relu(linear(h, layer))
    return torch.sigmoid(linear(h, params["head"]))
