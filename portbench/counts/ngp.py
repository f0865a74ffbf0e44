"""Instant-NGP's network: its arithmetic a point, from the configuration's widths.

The hash encoding's trilinear interpolation (``counts.hashgrid``: L 8 (2 +
2 F) flops) and the MLPs' multiply-adds: the density MLP (L F -> 64 -> 16)
and the colour MLP (16 + SH -> 64 -> 64 -> 3), no biases. At the published
widths that is 9,408 multiply-adds a point, 19,584 flops with the
interpolation's 768. The index arithmetic is integer work, not counted.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from . import hashgrid


def layer_shapes(cfg: Dict) -> List[Tuple[int, int]]:
    """The published widths: density L F -> 64 -> 16, colour 16 + deg^2 ->
    64 -> 64 -> 3."""
    L, F = int(cfg["network.xyz_encoder.n_levels"]), int(cfg["network.xyz_encoder.n_features"])
    deg = int(cfg["network.dir_encoder.degree"])
    return [(L * F, 64), (64, 16), (16 + deg * deg, 64), (64, 64), (64, 3)]


def macs_per_point(cfg: Dict) -> int:
    return sum(i * o for i, o in layer_shapes(cfg))


def forward_flops_per_point(cfg: Dict) -> float:
    return 2.0 * macs_per_point(cfg) + hashgrid.flops_per_point(cfg)
