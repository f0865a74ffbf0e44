"""Multiply-adds and parameters of the NeRF MLP, from its widths.

D layers of width W on the xyz encoding (the encoding joined again after
each skip layer), alpha_linear W -> 1, feature_linear W -> W, one view
layer (W + views) -> W / 2, rgb_linear W / 2 -> 3. For lego (D 8, W 256,
skip 4, 63 + 27 inputs) that is 593,408 multiply-adds a point, the
figure the port's smoke test uses (``MACS_PER_POINT``).
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple


def layer_shapes(D: int, W: int, input_ch: int, input_ch_views: int,
                 skips: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """(fan_in, fan_out) of every dense layer."""
    out, fan_in = [], input_ch
    for i in range(D):
        out.append((fan_in, W))
        fan_in = W + input_ch if i in skips else W
    out += [(W, 1), (W, W), (W + input_ch_views, W // 2), (W // 2, 3)]
    return tuple(out)


def macs_per_point(D: int, W: int, input_ch: int, input_ch_views: int,
                   skips: Sequence[int]) -> int:
    return sum(i * o for i, o in layer_shapes(D, W, input_ch, input_ch_views, skips))


def n_biases(D: int, W: int, input_ch: int, input_ch_views: int, skips: Sequence[int]) -> int:
    return sum(o for _, o in layer_shapes(D, W, input_ch, input_ch_views, skips))


def shape_of(cfg: Dict) -> Dict:
    """The widths of a configuration file's ``cfg`` keys."""
    hashgrid = str(cfg["network.xyz_encoder.type"]) in ("hashgrid", "grid_hash")
    input_ch = (int(cfg["network.xyz_encoder.n_levels"]) * int(cfg["network.xyz_encoder.n_features"])
                if hashgrid else 3 * (2 * int(cfg["network.xyz_encoder.freq"]) + 1))
    return dict(D=int(cfg["network.nerf.D"]), W=int(cfg["network.nerf.W"]), input_ch=input_ch,
                input_ch_views=3 * (2 * int(cfg["network.dir_encoder.freq"]) + 1),
                skips=tuple(int(s) for s in cfg["network.nerf.skips"]))


def forward_flops_per_point(cfg: Dict) -> float:
    """The model's own arithmetic a point: the MLP's products (2 a
    multiply-add) and, for a hash grid, the trilinear interpolation."""
    from . import hashgrid
    flops = 2.0 * macs_per_point(**shape_of(cfg))
    if str(cfg["network.xyz_encoder.type"]) in ("hashgrid", "grid_hash"):
        flops += hashgrid.flops_per_point(cfg)
    return flops
