"""The hash encoder's arithmetic and its table's size.

A point reads 2^3 corners at each of L levels; their weights take 2
multiplies a corner and the interpolation one multiply-add a feature a
corner: L 8 (2 + 2 F) flops. The index arithmetic is integer work and is
not counted.
"""
from __future__ import annotations

from typing import Dict


def flops_per_point(cfg: Dict) -> float:
    L = int(cfg["network.xyz_encoder.n_levels"])
    F = int(cfg["network.xyz_encoder.n_features"])
    return L * 8 * (2.0 + 2.0 * F)


def rows_per_point(cfg: Dict) -> int:
    return int(cfg["network.xyz_encoder.n_levels"]) * 8


def row_bytes(cfg: Dict) -> int:
    size = {"bfloat16": 2, "float16": 2, "float32": 4}[str(cfg.get("network.xyz_encoder.dtype",
                                                                   "bfloat16"))]
    return int(cfg["network.xyz_encoder.n_features"]) * size


def table_rows(cfg: Dict) -> int:
    return int(cfg["network.xyz_encoder.n_levels"]) << int(cfg["network.xyz_encoder.log2_hashmap_size"])
