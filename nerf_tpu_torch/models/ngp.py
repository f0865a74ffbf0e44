"""Instant-NGP's NeRF network (Mueller et al. 2022, arXiv:2201.05989, section 5.4).

No counterpart in ``nerf_tpu``: the JAX package's hash-grid NeRF puts the
hash encoding in front of a 4 x 128 NeRF MLP. This is the paper's network:

- the multiresolution hash encoding of the point (``models/hashgrid.py``):
  L levels of F features, 2^log2 T rows a level, over the box [-b, b]^3;
- a density MLP of one ReLU layer of 64 with 16 outputs, the first of
  which is the log of the density (``sigma_activation: exp`` in the
  compositing);
- a colour MLP fed those outputs and the 16 spherical harmonics (degree 4)
  of the unit view direction (``models/encoders.sh_encode``): two ReLU
  layers of 64, then 3 logits (sigmoid in the compositing);
- no bias terms (tiny-cuda-nn's fully fused MLPs have none).

The tree, in flatten order: ``color_mlp`` [{"w"}, ...], ``density_mlp``
[{"w"}, ...], ``xyz_encoder`` {"table"}; weights [in, out] as in the NeRF
MLP's trees. Each product rounds its operands to the compute dtype and sums
in float32 (``matmul``), the port's MLP precision. ``apply_ngp`` returns
[rgb logits, log density], the layout of the NeRF MLP's raw output.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from .encoders import sh_encode
from .hashgrid import init_hashgrid

Tree = Dict[str, Any]


# the published widths (section 5.4): one hidden layer of 64 with 16 outputs
# for the density, two of 64 for the colour, directions by SH of degree 4
DENSITY_WIDTH, GEO_FEATURES, COLOR_WIDTH, SH_DEGREE = 64, 16, 64, 4


def layer_shapes(input_ch: int) -> Dict[str, List[Tuple[int, int]]]:
    """(fan_in, fan_out) of each layer of the two MLPs, for an encoding of
    ``input_ch`` values (L F)."""
    return {"density_mlp": [(input_ch, DENSITY_WIDTH), (DENSITY_WIDTH, GEO_FEATURES)],
            "color_mlp": [(GEO_FEATURES + SH_DEGREE ** 2, COLOR_WIDTH),
                          (COLOR_WIDTH, COLOR_WIDTH), (COLOR_WIDTH, 3)]}


def leaf_shapes(shapes: Dict[str, List[Tuple[int, int]]], table_shape: Tuple[int, ...]
                ) -> List[Tuple[tuple, tuple]]:
    """[(path, shape)] of the network's leaves in flatten order."""
    out = [((name, i, "w"), s) for name in ("color_mlp", "density_mlp")
           for i, s in enumerate(shapes[name])]
    return out + [(("xyz_encoder", "table"), tuple(table_shape))]


def init_ngp(generator: Optional[torch.Generator], shapes: Dict[str, List[Tuple[int, int]]],
             n_levels: int, n_features: int, log2_table_size: int,
             table_scale: float = 1e-4, table_dtype: torch.dtype = torch.float32,
             device=None) -> Tree:
    """The network with its table drawn first, U(-table_scale, table_scale)
    (the paper's 1e-4), then each weight Xavier-uniform, U(+-sqrt(6 /
    (fan_in + fan_out))) as tiny-cuda-nn draws them, density MLP first; all
    from ``generator``; contiguous leaves on ``device`` that require grad."""
    table = init_hashgrid(generator, n_levels=n_levels, n_features=n_features,
                          log2_table_size=log2_table_size, init_scale=table_scale,
                          dtype=table_dtype, device=device)["table"]
    tree: Tree = {"xyz_encoder": {"table": table.requires_grad_(True)}}
    for name in ("density_mlp", "color_mlp"):
        layers = []
        for fan_in, fan_out in shapes[name]:
            bound = (6.0 / (fan_in + fan_out)) ** 0.5
            w = torch.empty(fan_in, fan_out).uniform_(-bound, bound, generator=generator)
            layers.append({"w": w.to(device).contiguous().requires_grad_(True)})
        tree[name] = layers
    return tree


def matmul(h: torch.Tensor, w: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """h @ w (w [in, out]) with both operands rounded to ``compute_dtype``
    and the products summed in float32."""
    return h.to(compute_dtype).float() @ w.to(compute_dtype).float()


def _mlp(layers, h: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    for layer in layers[:-1]:
        h = torch.relu(matmul(h, layer["w"], compute_dtype))
    return matmul(h, layers[-1]["w"], compute_dtype)


def density_outputs(params: Tree, feats: torch.Tensor, compute_dtype: torch.dtype
                    ) -> torch.Tensor:
    """feats [P, L F] -> the density MLP's outputs [P, geo_features]."""
    return _mlp(params["density_mlp"], feats, compute_dtype)


def apply_ngp(params: Tree, feats: torch.Tensor, sh: torch.Tensor,
              compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """feats [P, L F] (the hash encoding), sh [P, sh_dim] -> raw [P, 4]:
    the colour logits and the log density (the density MLP's first output)."""
    geo = density_outputs(params, feats, compute_dtype)
    rgb = _mlp(params["color_mlp"], torch.cat([geo, sh], dim=-1), compute_dtype)
    return torch.cat([rgb, geo[:, :1]], dim=-1)


def dir_encoding(viewdirs: torch.Tensor) -> torch.Tensor:
    """The colour MLP's direction input: the SH basis of unit directions."""
    return sh_encode(viewdirs, SH_DEGREE)
