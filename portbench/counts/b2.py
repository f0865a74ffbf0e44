"""B2, the fused MLP backward (``csrc/fused_mlp_bwd.cu``) as the train step
calls it (no input gradients): the lower bound of one call's time.

Operations (the smoke test's ``BWD_MACS_PER_POINT``): the forward again,
the weight gradient of every layer, and the input gradient of every layer
but layer 0 and the encoding columns of the skip layer and of the view
layer. Bytes: points, directions and the output cotangent (40 B a point),
the bf16 weights and float32 biases read, their float32 gradients written.
"""
from __future__ import annotations

from typing import Dict, Iterable

from . import nerf_mlp, peaks


def pad16(n: int) -> int:
    return -(-n // 16) * 16


def macs_per_point(cfg: Dict) -> int:
    """The smoke test's count: the encodings' columns that take no input
    gradient are counted at the kernel's 16-padded widths (64 and 32 for
    lego), which understates the work by a few padding columns."""
    shape = nerf_mlp.shape_of(cfg)
    fwd = nerf_mlp.macs_per_point(**shape)
    W, skips = shape["W"], shape["skips"]
    enc = pad16(shape["input_ch"])
    no_dx = enc * W  # layer 0
    no_dx += sum(enc * W for _ in skips)  # the skip layers' encoding columns
    no_dx += pad16(shape["input_ch_views"]) * (W // 2)  # the view layer's encoding columns
    return 2 * fwd + fwd - no_dx


def launch_bound_s(n_points: int, cfg: Dict) -> float:
    shape = nerf_mlp.shape_of(cfg)
    n_w, n_b = nerf_mlp.macs_per_point(**shape), nerf_mlp.n_biases(**shape)
    flops = 2.0 * macs_per_point(cfg) * n_points
    nbytes = 40 * n_points + 2 * n_w + 4 * n_b + 4 * (n_w + n_b)
    return max(flops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES)


def bound_s(calls: Iterable[int], cfg: Dict) -> float:
    return sum(launch_bound_s(n, cfg) for n in calls)
