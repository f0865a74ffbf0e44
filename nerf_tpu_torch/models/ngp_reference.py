"""A plain reference of Instant-NGP's NeRF network, for the tests.

Written from the paper (Mueller et al. 2022, arXiv:2201.05989: the
multiresolution hash encoding of section 3, the NeRF network of section
5.4, the optimizer of section 4) in plain ``torch`` on float32 tensors,
independent of the port's code: it imports no module of the port, no
kernel and no JAX. The tests hold the port's path (``models/ngp.py``,
``render/renderer.py``'s ``query_ngp``, ``render/composite.py``, the
optimizer) against it; run its products with TF32 off on a card
(``torch.backends.cuda.matmul.allow_tf32 = False``).

- ``encode``: each level's 8 cell corners around the point in the box
  [-bound, bound]^3, indexed directly where the level's (res + 1)^3
  lattice fits in its T rows, else by the XOR of the corner's coordinates
  times (1, 2654435761, 805459861) mod T, trilinearly weighted;
- ``sh_basis``: the real spherical harmonics of degree 4 (16 values);
- ``forward``: the density MLP (no bias, ReLU), exp of its first output,
  the colour MLP on [density outputs, SH], sigmoid;
- ``composite``: alpha = 1 - exp(-sigma delta), T the product of
  (1 - alpha + 1e-10) before a sample, weights zeroed where T is under the
  ERT threshold, a white background;
- ``loss``: the MSE of the colours;
- ``adam_step``: one Adam step with the value clip at 40, the L2 term on
  the MLP weights, and no step where a table entry's gradient is 0.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Tuple

import torch

PRIMES = (1, 2654435761, 805459861)


@dataclasses.dataclass(frozen=True)
class Spec:
    levels: int = 16
    features: int = 2
    log2_size: int = 19
    base: int = 16
    scale: float = 1.3819
    bound: float = 1.5
    ert: float = 1e-4
    white_bkgd: bool = True


def resolutions(spec: Spec) -> List[int]:
    return [int(math.floor(spec.base * spec.scale ** level)) for level in range(spec.levels)]


def corner_rows(spec: Spec, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """pts [N, 3] -> (rows [L, N, 8] into the table flattened to [L T, F],
    trilinear weights [L, N, 8])."""
    T = 1 << spec.log2_size
    x = ((pts - (-spec.bound)) / (2.0 * spec.bound)).clamp(0.0, 1.0 - 1e-6)
    offs = torch.tensor(list(itertools.product((0, 1), repeat=3)), device=pts.device)
    rows, weights = [], []
    for level, res in enumerate(resolutions(spec)):
        xl = x * float(res)
        cell = torch.floor(xl)
        frac = xl - cell
        c = cell.long()[:, None, :] + offs  # [N, 8, 3]
        if (res + 1) ** 3 <= T:
            idx = c[..., 0] + c[..., 1] * (res + 1) + c[..., 2] * (res + 1) ** 2
        else:
            idx = torch.zeros_like(c[..., 0])
            for d in range(3):
                idx = idx ^ ((c[..., d] * PRIMES[d]) & 0xFFFFFFFF)
        rows.append(idx % T + level * T)
        w = torch.where(offs == 1, frac[:, None, :], 1.0 - frac[:, None, :])
        weights.append(w[..., 0] * w[..., 1] * w[..., 2])
    return torch.stack(rows), torch.stack(weights)


def encode(spec: Spec, table: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """table [L, T, F], pts [N, 3] -> [N, L F]: level by level, the corners'
    features weighted and summed."""
    L, T, F = table.shape
    rows, w = corner_rows(spec, pts)
    feats = table.reshape(L * T, F)[rows]  # [L, N, 8, F]
    out = (feats * w[..., None]).sum(dim=2)
    return out.permute(1, 0, 2).reshape(pts.shape[0], L * F)


def sh_basis(d: torch.Tensor) -> torch.Tensor:
    """Unit directions [..., 3] -> the 16 real SH values of degrees 0-3."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),
        -0.4886025119029199 * y, 0.4886025119029199 * z, -0.4886025119029199 * x,
        1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
        0.31539156525252005 * (2.0 * zz - xx - yy), -1.0925484305920792 * x * z,
        0.5462742152960396 * (xx - yy),
        -0.5900435899266435 * y * (3.0 * xx - yy), 2.890611442640554 * x * y * z,
        -0.4570457994644658 * y * (4.0 * zz - xx - yy),
        0.3731763325901154 * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
        -0.4570457994644658 * x * (4.0 * zz - xx - yy),
        1.445305721320277 * z * (xx - yy), -0.5900435899266435 * x * (xx - 3.0 * yy)], dim=-1)


def mlp(weights: List[torch.Tensor], h: torch.Tensor) -> torch.Tensor:
    """ReLU between bias-free layers (weights [in, out]), none after the last."""
    for w in weights[:-1]:
        h = torch.relu(h @ w)
    return h @ weights[-1]


def forward(spec: Spec, net: Dict, pts: torch.Tensor, dirs: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pts [P, 3], unit dirs [P, 3] -> (rgb logits [P, 3], log density [P])."""
    geo = mlp([l["w"] for l in net["density_mlp"]], encode(spec, net["xyz_encoder"]["table"], pts))
    rgb = mlp([l["w"] for l in net["color_mlp"]], torch.cat([geo, sh_basis(dirs)], dim=-1))
    return rgb, geo[:, 0]


def composite(spec: Spec, rgb_logits: torch.Tensor, log_sigma: torch.Tensor,
              z: torch.Tensor, rays_d: torch.Tensor) -> Dict[str, torch.Tensor]:
    """[N, S, 3] logits, [N, S] log densities at depths z [N, S] along
    rays_d [N, 3] -> rgb [N, 3], acc, depth [N], weights [N, S]."""
    delta = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    delta = delta * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.exp(log_sigma) * delta)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[:, :1]),
                                     1.0 - alpha[:, :-1] + 1e-10], dim=-1), dim=-1)
    w = alpha * trans * (trans >= spec.ert).float()
    acc = w.sum(dim=-1)
    rgb = (w[..., None] * torch.sigmoid(rgb_logits)).sum(dim=1)
    if spec.white_bkgd:
        rgb = rgb + (1.0 - acc[:, None])
    return {"rgb": rgb, "acc": acc, "depth": (w * z).sum(dim=-1), "weights": w}


def render(spec: Spec, net: Dict, rays_o: torch.Tensor, rays_d: torch.Tensor,
           z: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The rays' samples at depths z [N, S] through the network and the
    compositing."""
    n, s = z.shape
    pts = (rays_o[:, None, :] + rays_d[:, None, :] * z[..., None]).reshape(-1, 3)
    dirs = rays_d[:, None, :].expand(n, s, 3).reshape(-1, 3)
    rgb, log_sigma = forward(spec, net, pts, dirs)
    return composite(spec, rgb.reshape(n, s, 3), log_sigma.reshape(n, s), z, rays_d)


def loss(rgb: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean((rgb - target) ** 2)


def adam_step(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              count: int, lr: float, b1: float = 0.9, b2: float = 0.99, eps: float = 1e-15,
              l2: float = 0.0, skip_zero: bool = False, clip: float = 40.0
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step (``count`` the step's number, 1 for the first) on the
    gradient clipped to +-clip plus ``l2 * p``; with ``skip_zero``, elements
    whose gradient is exactly 0 keep p, mu and nu. Returns (p, mu, nu)."""
    step = g != 0 if skip_zero else torch.ones_like(g, dtype=torch.bool)
    g = g.clamp(-clip, clip) + l2 * p
    new_mu = (1.0 - b1) * g + b1 * mu
    new_nu = (1.0 - b2) * g * g + b2 * nu
    upd = (new_mu / (1.0 - b1 ** count)) / (torch.sqrt(new_nu / (1.0 - b2 ** count)) + eps)
    return (torch.where(step, p - lr * upd, p), torch.where(step, new_mu, mu),
            torch.where(step, new_nu, nu))
