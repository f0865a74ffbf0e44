"""B1, the fused MLP forward (``csrc/fused_mlp.cu``), one launch a batch of
points: the lower bound of its time.

A launch of n points needs 2 n MACs flops at the bf16 peak, or its bytes at
HBM's: the points and directions read (24 B a point), raw written (16 B a
point), the bf16 weights and float32 biases read once (the smoke test's
``FUSED_IO_BYTES`` and weight buffers, without the kernel's padding).
"""
from __future__ import annotations

from typing import Dict, Iterable

from . import nerf_mlp, peaks

IO_BYTES = 40


def launch_bound_s(n_points: int, cfg: Dict) -> float:
    shape = nerf_mlp.shape_of(cfg)
    flops = 2.0 * nerf_mlp.macs_per_point(**shape) * n_points
    nbytes = (IO_BYTES * n_points + 2 * nerf_mlp.macs_per_point(**shape)
              + 4 * nerf_mlp.n_biases(**shape))
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)


def bound_s(calls: Iterable[int], cfg: Dict) -> float:
    """The bound of launches of the given point counts, summed."""
    return sum(launch_bound_s(n, cfg) for n in calls)
