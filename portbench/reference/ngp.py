"""The plain Instant-NGP NeRF network that the benchmark holds the port against.

Written out in plain PyTorch on float32 tensors, with TF32 off, from the
paper (Mueller et al. 2022, arXiv:2201.05989: the multiresolution hash
encoding of section 3, the NeRF network of section 5.4, the optimizer of
section 4) and the departures its configuration file lists under
``assumed``. It imports torch, numpy and ``reference/nerf.py``'s helpers
(the float32 switch, fp8 rounding, rays, the ESS grid and its coarse
samples), nothing of the program.

``precision="fp8"`` is the control: the table and every operand of the
MLPs' products go through float8 e4m3 with one scale a tensor. ``fault``
plants one of the faults a port of this network can carry, for the
limits' readings: ``prime`` (the finest level hashes with 2654435769 in
place of 2654435761), ``softplus`` (softplus for exp as the density),
``sh3`` (spherical harmonics of degree 3, the degree-3 coefficients 0).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import nerf

PRIMES = (1, 2654435761, 805459861)
WRONG_PRIME = 2654435769
FAULTS = ("prime", "softplus", "sh3")


@dataclasses.dataclass(frozen=True)
class Model:
    """The sizes of the configuration, read from its file's ``cfg`` keys."""
    levels: int
    features: int
    log2_size: int
    base: int
    scale: float
    bound: float
    sh_degree: int
    n_samples: int
    near: float
    far: float
    perturb: bool
    white_bkgd: bool
    ert: float
    grid_resolution: int
    density: List[Tuple[int, int]]
    color: List[Tuple[int, int]]

    @classmethod
    def from_cfg(cls, cfg: Dict) -> "Model":
        """The published widths (section 5.4): density L F -> 64 -> 16,
        colour 16 + deg^2 -> 64 -> 64 -> 3."""
        L, Fe = int(cfg["network.xyz_encoder.n_levels"]), int(cfg["network.xyz_encoder.n_features"])
        deg = int(cfg["network.dir_encoder.degree"])
        density = [(L * Fe, 64), (64, 16)]
        color = [(16 + deg * deg, 64), (64, 64), (64, 3)]
        return cls(levels=L, features=Fe, log2_size=int(cfg["network.xyz_encoder.log2_hashmap_size"]),
                   base=int(cfg["network.xyz_encoder.base_resolution"]),
                   scale=float(cfg["network.xyz_encoder.per_level_scale"]),
                   bound=float(cfg["network.xyz_encoder.bound"]), sh_degree=deg,
                   n_samples=int(cfg["task_arg.N_samples"]), near=float(cfg["near"]),
                   far=float(cfg["far"]), perturb=float(cfg["task_arg.perturb"]) > 0,
                   white_bkgd=bool(cfg["task_arg.white_bkgd"]), ert=float(cfg["ert_threshold"]),
                   grid_resolution=int(cfg["occupancy_grid_resolution"]),
                   density=density, color=color)


def leaf_paths(m: Model) -> List[Tuple[Tuple, Tuple[int, ...]]]:
    """(path, shape) of the network's leaves in the program's order (keys
    sorted, lists in order) under its one model, ``coarse``."""
    out = [(("coarse", "color_mlp", i, "w"), s) for i, s in enumerate(m.color)]
    out += [(("coarse", "density_mlp", i, "w"), s) for i, s in enumerate(m.density)]
    return out + [(("coarse", "xyz_encoder", "table"), (m.levels, 1 << m.log2_size, m.features))]


def corner_rows(m: Model, pts: torch.Tensor, fault: Optional[str] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pts [N, 3] -> (rows [L, N, 8] into the table flattened to [L T, F],
    trilinear weights [L, N, 8]): level l's resolution floor(base scale^l),
    the box [-bound, bound]^3 clamped, its (res + 1)^3 lattice indexed
    directly where it fits in T rows, else hashed."""
    T = 1 << m.log2_size
    x = ((pts + m.bound) / (2.0 * m.bound)).clamp(0.0, 1.0 - 1e-6)
    offs = torch.tensor(list(itertools.product((0, 1), repeat=3)), device=pts.device)
    rows, weights = [], []
    for level in range(m.levels):
        res = int(np.floor(m.base * m.scale ** level))
        xl = x * float(res)
        cell = torch.floor(xl)
        frac = xl - cell
        c = cell.long()[:, None, :] + offs
        if (res + 1) ** 3 <= T:
            idx = c[..., 0] + c[..., 1] * (res + 1) + c[..., 2] * (res + 1) ** 2
        else:
            primes = PRIMES
            if fault == "prime" and level == m.levels - 1:
                primes = (PRIMES[0], WRONG_PRIME, PRIMES[2])
            idx = torch.zeros_like(c[..., 0])
            for d in range(3):
                idx = idx ^ ((c[..., d] * primes[d]) & 0xFFFFFFFF)
        rows.append(idx % T + level * T)
        w = torch.where(offs == 1, frac[:, None, :], 1.0 - frac[:, None, :])
        weights.append(w[..., 0] * w[..., 1] * w[..., 2])
    return torch.stack(rows), torch.stack(weights)


def encode(m: Model, table: torch.Tensor, pts: torch.Tensor, precision: str,
           fault: Optional[str] = None) -> torch.Tensor:
    L, T, Fe = table.shape
    rows, w = corner_rows(m, pts, fault)
    feats = nerf.quantize(table, precision).reshape(L * T, Fe)[rows]
    out = (feats * w[..., None]).sum(dim=2)
    return out.permute(1, 0, 2).reshape(pts.shape[0], L * Fe)


def sh_basis(d: torch.Tensor, degree: int) -> torch.Tensor:
    """Unit directions [..., 3] -> the real SH values of degrees below
    ``degree`` (at most 4), padded with zeros to 16."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    vals = [torch.full_like(x, 0.28209479177387814),
            -0.4886025119029199 * y, 0.4886025119029199 * z, -0.4886025119029199 * x,
            1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
            0.31539156525252005 * (2.0 * zz - xx - yy), -1.0925484305920792 * x * z,
            0.5462742152960396 * (xx - yy),
            -0.5900435899266435 * y * (3.0 * xx - yy), 2.890611442640554 * x * y * z,
            -0.4570457994644658 * y * (4.0 * zz - xx - yy),
            0.3731763325901154 * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
            -0.4570457994644658 * x * (4.0 * zz - xx - yy),
            1.445305721320277 * z * (xx - yy), -0.5900435899266435 * x * (xx - 3.0 * yy)]
    keep = degree * degree
    return torch.stack([v if i < keep else torch.zeros_like(x) for i, v in enumerate(vals)], -1)


def mlp(layers: List[Dict], h: torch.Tensor, precision: str) -> torch.Tensor:
    for i, layer in enumerate(layers):
        h = nerf.quantize(h, precision) @ nerf.quantize(layer["w"], precision)
        if i + 1 < len(layers):
            h = torch.relu(h)
    return h


def query(m: Model, net: Dict, pts: torch.Tensor, dirs: torch.Tensor, precision: str,
          fault: Optional[str] = None) -> torch.Tensor:
    """pts [N, S, 3], unit dirs [N, 3] -> raw [N, S, 4] (rgb logits, log density)."""
    n, s, _ = pts.shape
    geo = mlp(net["density_mlp"], encode(m, net["xyz_encoder"]["table"], pts.reshape(-1, 3),
                                         precision, fault), precision)
    degree = 3 if fault == "sh3" else m.sh_degree
    sh = sh_basis(dirs, degree)[:, None, :].expand(n, s, 16).reshape(n * s, 16)
    rgb = mlp(net["color_mlp"], torch.cat([geo, sh], dim=-1), precision)
    return torch.cat([rgb, geo[:, :1]], dim=-1).reshape(n, s, 4)


@torch.no_grad()
def density(m: Model, net: Dict, pts: torch.Tensor, precision: str = "float32") -> torch.Tensor:
    """exp of the density MLP's first output at pts [M, 3]."""
    geo = mlp(net["density_mlp"], encode(m, net["xyz_encoder"]["table"], pts, precision), precision)
    return torch.exp(geo[:, 0])


def composite(m: Model, raw: torch.Tensor, z: torch.Tensor, d: torch.Tensor,
              fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Alpha compositing of exp densities with a 1e10 last interval, early
    ray termination (a weight is 0 where the incoming transmittance is under
    the threshold) and a white background."""
    dists = torch.cat([z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(d, dim=-1, keepdim=True)
    sigma = F.softplus(raw[..., 3]) if fault == "softplus" else torch.exp(raw[..., 3])
    alpha = 1.0 - torch.exp(-sigma * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha[..., :-1] + 1e-10], dim=-1), dim=-1)
    w = alpha * trans * (trans >= m.ert).float()
    acc = w.sum(dim=-1)
    rgb = (w[..., None] * torch.sigmoid(raw[..., :3])).sum(dim=-2)
    if m.white_bkgd:
        rgb = rgb + (1.0 - acc[..., None])
    return {"rgb": rgb, "acc": acc}


def render_rays(m: Model, net: Dict, o: torch.Tensor, d: torch.Tensor,
                grid: Optional[torch.Tensor], u: Optional[torch.Tensor], precision: str,
                fault: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """One pass: ESS-refocused coarse samples jittered by u, the network,
    the compositing."""
    z = nerf.coarse_z(m, grid, o, d, u)
    raw = query(m, net, o[:, None] + d[:, None] * z[..., None], d, precision, fault)
    return composite(m, raw, z, d, fault)


def train_draws(gen: torch.Generator, n_rays: int, n_images: int, n_pixels: int, m: Model,
                device):
    """One step's draws in the program's order: image indices, pixel
    indices, the coarse jitter."""
    img = torch.randint(0, n_images, (n_rays,), generator=gen, device=device)
    pix = torch.randint(0, n_pixels, (n_rays,), generator=gen, device=device)
    u = torch.rand((n_rays, m.n_samples), generator=gen, device=device) if m.perturb else None
    return img, pix, u


def adam_step(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, count: int,
              lr: float, b1: float, b2: float, eps: float, l2: float, skip_zero: bool,
              clip: float = 40.0) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step on the gradient clipped to +-clip plus ``l2 * p``;
    with ``skip_zero`` an element whose gradient is exactly 0 keeps p, mu
    and nu. Returns (p, mu, nu)."""
    step = g != 0 if skip_zero else torch.ones_like(g, dtype=torch.bool)
    g = g.clamp(-clip, clip) + l2 * p
    new_mu = (1.0 - b1) * g + b1 * mu
    new_nu = (1.0 - b2) * g * g + b2 * nu
    upd = (new_mu / (1.0 - b1 ** count)) / (torch.sqrt(new_nu / (1.0 - b2 ** count)) + eps)
    return (torch.where(step, p - lr * upd, p), torch.where(step, new_mu, mu),
            torch.where(step, new_nu, nu))
