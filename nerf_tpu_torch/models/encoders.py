"""Positional (frequency) encoding; counterpart of ``nerf_tpu/models/encoders.py``.

Output channel layout, the one the checkpoints' first-layer rows follow:
    [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]
out_dim = d * (2*num_freqs + 1): xyz with 10 freqs -> 63, dirs with 4 -> 27.
"""
from __future__ import annotations

import numpy as np
import torch


def freq_bands(num_freqs: int) -> np.ndarray:
    """Log-sampled bands 2^0 ... 2^(num_freqs-1)."""
    return 2.0 ** np.linspace(0.0, num_freqs - 1, num_freqs)


def freq_encode(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """x: [..., d] -> [..., d*(2*num_freqs + 1)]."""
    bands = torch.as_tensor(freq_bands(num_freqs), dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * bands[:, None]  # [..., F, d]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)  # [..., F, 2d]
    return torch.cat([x, enc.reshape(*x.shape[:-1], 2 * num_freqs * x.shape[-1])], dim=-1)


def freq_out_dim(input_dim: int, num_freqs: int) -> int:
    return input_dim * (2 * num_freqs + 1)
