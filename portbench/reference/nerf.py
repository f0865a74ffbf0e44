"""The plain NeRF that the benchmark holds the port against.

Everything here is written out in plain PyTorch on float32 tensors, with
TF32 off, from the published descriptions (NeRF, Mildenhall et al. 2020;
Instant-NGP, Mueller et al. 2022) and the conventions of the checkpoints
and configs it reads. It imports torch and numpy and nothing of the
program. ``precision="fp8"`` is the control: every matrix product of the
MLPs and the hash table take their operands through float8 e4m3 with one
scale a tensor (the forward; the backward goes straight through), the
step below bfloat16 that a later change might be tempted to take.

Random numbers: the program draws each step's rays and jitter from one
``torch.Generator``; ``Replay`` draws the same numbers in the same order
(image and pixel indices, the coarse jitter, the fine-sample positions;
per render tile, the coarse jitter), so both sides see the same inputs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

F8_MAX = 448.0  # the largest finite float8 e4m3 value
PRIMES = (1, 2654435761, 805459861)
MASK32 = 0xFFFFFFFF


@contextlib.contextmanager
def full_float32():
    """float32 products in full float32 on CUDA inside the block."""
    mm = torch.backends.cuda.matmul
    prev = (mm.allow_tf32, torch.backends.cudnn.allow_tf32)
    mm.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        mm.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def quantize(x: torch.Tensor, precision: str) -> torch.Tensor:
    """x as the products see it: unchanged in float32; in fp8, scaled so that
    its largest magnitude is e4m3's largest, rounded to e4m3 and scaled back
    (gradients pass straight through)."""
    if precision == "float32":
        return x
    if precision != "fp8":
        raise ValueError(f"unknown precision {precision!r}")
    scale = x.detach().abs().amax().clamp_min(1e-30) / F8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x).detach()


@dataclasses.dataclass(frozen=True)
class Model:
    """The sizes of one configuration, read from its file's ``cfg`` keys."""
    depth: int
    width: int
    skips: Tuple[int, ...]
    xyz_freqs: int
    dir_freqs: int
    encoder: str  # "frequency" or "hashgrid"
    hash_levels: int
    hash_features: int
    hash_log2_size: int
    hash_base_res: int
    hash_scale: float
    sigma_activation: str
    n_samples: int
    n_importance: int
    near: float
    far: float
    perturb: bool
    white_bkgd: bool
    ert_threshold: Optional[float]
    ess: bool
    grid_resolution: int

    @classmethod
    def from_cfg(cls, cfg: Dict) -> "Model":
        enc = str(cfg["network.xyz_encoder.type"])
        return cls(
            depth=int(cfg["network.nerf.D"]), width=int(cfg["network.nerf.W"]),
            skips=tuple(int(s) for s in cfg["network.nerf.skips"]),
            xyz_freqs=int(cfg.get("network.xyz_encoder.freq", 10)),
            dir_freqs=int(cfg["network.dir_encoder.freq"]),
            encoder="hashgrid" if enc in ("hashgrid", "grid_hash") else enc,
            hash_levels=int(cfg.get("network.xyz_encoder.n_levels", 16)),
            hash_features=int(cfg.get("network.xyz_encoder.n_features", 2)),
            hash_log2_size=int(cfg.get("network.xyz_encoder.log2_hashmap_size", 19)),
            hash_base_res=int(cfg.get("network.xyz_encoder.base_resolution", 16)),
            hash_scale=float(cfg.get("network.xyz_encoder.per_level_scale", 1.3819)),
            sigma_activation=str(cfg.get("network.sigma_activation", "relu")),
            n_samples=int(cfg["task_arg.N_samples"]),
            n_importance=int(cfg["task_arg.N_importance"]),
            near=float(cfg["near"]), far=float(cfg["far"]),
            perturb=float(cfg["task_arg.perturb"]) > 0, white_bkgd=bool(cfg["task_arg.white_bkgd"]),
            ert_threshold=float(cfg["ert_threshold"]) if cfg["enable_ert"] else None,
            ess=bool(cfg["enable_ess"]), grid_resolution=int(cfg["occupancy_grid_resolution"]))

    @property
    def input_ch(self) -> int:
        if self.encoder == "hashgrid":
            return self.hash_levels * self.hash_features
        return 3 * (2 * self.xyz_freqs + 1)

    @property
    def input_ch_views(self) -> int:
        return 3 * (2 * self.dir_freqs + 1)


# ----------------------------------------------------------------- encoders

def freq_encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[..., d] -> [..., d (2 n + 1)]: x, then sin and cos of x 2^k for each k."""
    bands = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    xb = x[..., None, :] * bands[:, None]
    enc = torch.cat([torch.sin(xb), torch.cos(xb)], dim=-1)
    return torch.cat([x, enc.reshape(*x.shape[:-1], -1)], dim=-1)


def level_resolutions(m: Model) -> List[int]:
    return [int(np.floor(m.hash_base_res * m.hash_scale ** l)) for l in range(m.hash_levels)]


def hash_rows(m: Model, pts: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """pts [N, 3] in the box [-2, 2]^3 -> (rows [L, N, 8] int64 into the table
    flattened to [L T, F], weights [L, N, 8]): each level's 8 cell corners,
    indexed directly where the level's (res + 1)^3 lattice fits in its T
    rows, else by the XOR of the coordinates times the primes, mod T."""
    T = 1 << m.hash_log2_size
    x = ((pts.float() + 2.0) / 4.0).clamp(0.0, 1.0 - 1e-6)
    offs = torch.tensor(list(itertools.product((0, 1), repeat=3)), device=pts.device)
    rows, weights = [], []
    for level, res in enumerate(level_resolutions(m)):
        xl = x * float(res)
        x0 = torch.floor(xl)
        frac = xl - x0
        c = x0.to(torch.int64)[:, None, :] + offs  # [N, 8, 3]
        if (res + 1) ** 3 <= T:
            idx = (c[..., 0] + c[..., 1] * (res + 1) + c[..., 2] * (res + 1) ** 2) % T
        else:
            h = (c[..., 0] * PRIMES[0]) & MASK32
            h = h ^ ((c[..., 1] * PRIMES[1]) & MASK32)
            h = h ^ ((c[..., 2] * PRIMES[2]) & MASK32)
            idx = h % T
        w = torch.where(offs == 1, frac[:, None, :], 1.0 - frac[:, None, :])
        rows.append(idx + level * T)
        weights.append(w[..., 0] * w[..., 1] * w[..., 2])
    return torch.stack(rows), torch.stack(weights)


def hash_encode(m: Model, table: torch.Tensor, pts: torch.Tensor, precision: str
                ) -> torch.Tensor:
    """pts [N, 3] -> [N, L F]: each level's corner features, trilinearly
    weighted. ``table`` [L, T, F] float32."""
    L, T, Fe = table.shape
    rows, w = hash_rows(m, pts)
    flat = quantize(table, precision).reshape(L * T, Fe)
    feats = flat[rows.reshape(-1)].reshape(L, pts.shape[0], 8, Fe)
    out = (feats * w[..., None]).sum(dim=2)  # [L, N, F]
    return out.permute(1, 0, 2).reshape(pts.shape[0], L * Fe)


# --------------------------------------------------------------------- MLP

def mlp(m: Model, p: Dict, x: torch.Tensor, precision: str) -> torch.Tensor:
    """x [P, input_ch + input_ch_views] -> raw [P, 4] (rgb logits, sigma) of
    the NeRF MLP: D ReLU layers of width W with the input concatenated after
    each skip layer, sigma from alpha_linear, a 256 -> 256 feature layer
    joined with the view encoding, one ReLU layer of W / 2, rgb_linear.
    Weights [in, out]."""
    def lin(layer, h):
        return quantize(h, precision) @ quantize(layer["w"], precision) + layer["b"]

    pts_in, views = x[:, :m.input_ch], x[:, m.input_ch:]
    h = pts_in
    for i, layer in enumerate(p["pts_linears"]):
        h = torch.relu(lin(layer, h))
        if i in m.skips:
            h = torch.cat([pts_in, h], dim=-1)
    alpha = lin(p["alpha_linear"], h)
    h = torch.cat([lin(p["feature_linear"], h), views], dim=-1)
    for layer in p["views_linears"]:
        h = torch.relu(lin(layer, h))
    return torch.cat([lin(p["rgb_linear"], h), alpha], dim=-1)


def query(m: Model, p: Dict, pts: torch.Tensor, dirs: torch.Tensor, precision: str
          ) -> torch.Tensor:
    """pts [N, S, 3], unit dirs [N, 3] -> raw [N, S, 4]."""
    n, s, _ = pts.shape
    flat = pts.reshape(-1, 3)
    if m.encoder == "hashgrid":
        emb = hash_encode(m, p["xyz_encoder"]["table"], flat, precision)
    else:
        emb = freq_encode(flat, m.xyz_freqs)
    views = freq_encode(dirs[:, None, :].expand(n, s, 3).reshape(-1, 3), m.dir_freqs)
    return mlp(m, p, torch.cat([emb, views], dim=-1), precision).reshape(n, s, 4)


def density(m: Model, p: Dict, pts: torch.Tensor, precision: str) -> torch.Tensor:
    """Activated density at pts [M, 3] (a zero view encoding)."""
    if m.encoder == "hashgrid":
        emb = hash_encode(m, p["xyz_encoder"]["table"], pts, precision)
    else:
        emb = freq_encode(pts, m.xyz_freqs)
    x = torch.cat([emb, emb.new_zeros(pts.shape[0], m.input_ch_views)], dim=-1)
    return activate(m, mlp(m, p, x, precision)[:, 3])


def activate(m: Model, sigma: torch.Tensor) -> torch.Tensor:
    return F.softplus(sigma) if m.sigma_activation == "softplus" else torch.relu(sigma)


# ------------------------------------------------------------------- rays

def pixel_rays(col: torch.Tensor, row: torch.Tensor, K: torch.Tensor, c2w: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pixel centres at integer (col, row), camera looking down -z with y up
    (the Blender convention); c2w [4, 4] or one per pixel [..., 4, 4] ->
    (origins, unit directions) [..., 3]."""
    d = torch.stack([(col - K[0, 2]) / K[0, 0], -(row - K[1, 2]) / K[1, 1],
                     -torch.ones_like(col)], dim=-1)
    d = (c2w[..., :3, :3] @ d[..., None])[..., 0]
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[..., :3, 3].expand(d.shape), d


def image_rays(H: int, W: int, K: torch.Tensor, c2w: torch.Tensor):
    row, col = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=c2w.device),
                              torch.arange(W, dtype=torch.float32, device=c2w.device),
                              indexing="ij")
    o, d = pixel_rays(col.reshape(-1), row.reshape(-1), K, c2w)
    return o.contiguous(), d.contiguous()


# -------------------------------------------------------------- ESS grid

BOX = 2.0  # the scene box [-2, 2]^3


def seed_grid(res: int, generator: torch.Generator, device) -> torch.Tensor:
    """The trainer's starting grid: a sphere of radius 1.2 in [-1, 1]
    coordinates of the cell indices, or'd with a tenth of the cells at random."""
    ax = torch.arange(res, dtype=torch.float32, device=device) / (res - 1) * 2.0 - 1.0
    sphere = torch.linalg.norm(torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), dim=-1),
                               dim=-1) <= 1.2
    return sphere | (torch.rand((res, res, res), generator=generator, device=device) < 0.1)


@torch.no_grad()
def grid_from_density(m: Model, p: Dict, precision: str, device) -> torch.Tensor:
    """A cell is occupied where the density at any of its 27 lattice points
    (offsets 0, 1/2, 1 of a cell on each axis) exceeds 0.01."""
    res = m.grid_resolution
    cell = 2 * BOX / res
    base = torch.arange(res, dtype=torch.float32, device=device).repeat_interleave(3)
    offs = torch.tensor([0.0, 0.5, 1.0], device=device).repeat(res)
    ax = -BOX + base * cell + offs * cell
    occ = torch.empty((res, res, res), dtype=torch.bool, device=device)
    slab = 4  # cells along x a block
    for c0 in range(0, res, slab):
        c1 = min(res, c0 + slab)
        pts = torch.stack(torch.meshgrid(ax[3 * c0:3 * c1], ax, ax, indexing="ij"),
                          dim=-1).reshape(-1, 3)
        d = torch.cat([density(m, p, q, precision) for q in pts.split(1 << 20)])
        occ[c0:c1] = d.reshape(c1 - c0, 3, res, 3, res, 3).amax(dim=(1, 3, 5)) > 0.01
    return occ


def grid_lookup(grid: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    res = grid.shape[0]
    x = ((pts + BOX) / (2 * BOX)).clamp(0.0, 1.0)
    i = (x * (res - 1)).long().clamp(0, res - 1)
    return grid[i[..., 0], i[..., 1], i[..., 2]]


# --------------------------------------------------------------- sampling

def stratify(z: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    upper = torch.cat([mids, z[..., -1:]], dim=-1)
    lower = torch.cat([z[..., :1], mids], dim=-1)
    return lower + (upper - lower) * u


def coarse_z(m: Model, grid: Optional[torch.Tensor], o: torch.Tensor, d: torch.Tensor,
             u: Optional[torch.Tensor]) -> torch.Tensor:
    """The coarse samples: near..far evenly, or, for a ray whose probe samples
    are more than half empty and not all empty, evenly over its first..last
    occupied probe; then jittered within their bins by ``u``."""
    t = torch.linspace(0.0, 1.0, m.n_samples, device=o.device)
    z = (m.near * (1.0 - t) + m.far * t).expand(o.shape[0], m.n_samples)
    if grid is not None:
        occ = grid_lookup(grid, o[:, None, :] + d[:, None, :] * z[..., None])
        lo = torch.where(occ, z, torch.full_like(z, 1e10)).amin(dim=-1)
        hi = torch.where(occ, z, torch.full_like(z, -1e10)).amax(dim=-1)
        focus = (1.0 - occ.float().mean(dim=-1) > 0.5) & occ.any(dim=-1)
        z = torch.where(focus[:, None], lo[:, None] * (1.0 - t) + hi[:, None] * t, z)
    return stratify(z, u) if u is not None else z


def composite(m: Model, raw: torch.Tensor, z: torch.Tensor, d: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """Alpha compositing with a 1e10 last interval, early ray termination
    (weights where the incoming transmittance is under the threshold are 0)
    and a white background."""
    dists = torch.cat([z[..., 1:] - z[..., :-1], torch.full_like(z[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(d, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-activate(m, raw[..., 3]) * dists)
    trans = torch.cumprod(torch.cat([torch.ones_like(alpha[..., :1]),
                                     1.0 - alpha[..., :-1] + 1e-10], dim=-1), dim=-1)
    w = alpha * trans
    if m.ert_threshold is not None:
        w = w * (trans >= m.ert_threshold).float()
    acc = w.sum(dim=-1)
    rgb = (w[..., None] * torch.sigmoid(raw[..., :3])).sum(dim=-2)
    if m.white_bkgd:
        rgb = rgb + (1.0 - acc[..., None])
    return {"rgb": rgb, "acc": acc, "depth": (w * z).sum(dim=-1), "weights": w}


def sample_pdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Inverse-CDF samples at u [N, n] of the piecewise-constant pdf
    ``weights + 1e-5`` [N, M-1] over the bin edges [N, M]."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
    last = cdf.shape[-1] - 1
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below, above = (idx - 1).clamp(0, last), idx.clamp(0, last)
    cb, ca = cdf.gather(-1, below), cdf.gather(-1, above)
    bb, ba = bins.gather(-1, below), bins.gather(-1, above)
    den = torch.where(ca - cb < 1e-5, torch.ones_like(ca), ca - cb)
    return bb + (u - cb) / den * (ba - bb)


def render_rays(m: Model, models: Dict, o: torch.Tensor, d: torch.Tensor,
                grid: Optional[torch.Tensor], u_coarse: Optional[torch.Tensor],
                u_fine: Optional[torch.Tensor], precision: str) -> Dict[str, torch.Tensor]:
    """The hierarchical render of rays o, d [N, 3]: coarse samples (ESS),
    coarse MLP, compositing, fine samples from the coarse weights (at u_fine,
    or evenly spaced where it is None), the merged samples through the fine
    MLP, compositing. Returns rgb0, acc0 (coarse), rgb, acc, depth (fine)."""
    z = coarse_z(m, grid, o, d, u_coarse)
    c = composite(m, query(m, models["coarse"], o[:, None] + d[:, None] * z[..., None], d,
                           precision), z, d)
    mids = 0.5 * (z[..., 1:] + z[..., :-1])
    if u_fine is None:
        u_fine = torch.linspace(0.0, 1.0, m.n_importance, device=o.device).expand(
            o.shape[0], m.n_importance)
    zf = sample_pdf(mids.detach(), c["weights"][..., 1:-1].detach(), u_fine)
    z_all = torch.sort(torch.cat([z, zf], dim=-1), dim=-1).values
    f = composite(m, query(m, models["fine"], o[:, None] + d[:, None] * z_all[..., None], d,
                           precision), z_all, d)
    return {"rgb0": c["rgb"], "acc0": c["acc"], "rgb": f["rgb"], "acc": f["acc"],
            "depth": f["depth"]}


class Replay:
    """The program's draws from one generator, in its order."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.device = device

    def train_batch(self, n_rays: int, n_images: int, n_pixels: int, m: Model):
        """One step's draws: image indices, pixel indices, coarse jitter,
        fine-sample positions."""
        g, dev = self.gen, self.device
        img = torch.randint(0, n_images, (n_rays,), generator=g, device=dev)
        pix = torch.randint(0, n_pixels, (n_rays,), generator=g, device=dev)
        u_c = torch.rand((n_rays, m.n_samples), generator=g, device=dev) if m.perturb else None
        u_f = torch.rand((n_rays, m.n_importance), generator=g, device=dev)
        return img, pix, u_c, u_f

    def frame_jitter(self, n_rays: int, tile: int, m: Model) -> Optional[torch.Tensor]:
        """A frame's coarse jitter [n_rays, S], drawn tile by tile."""
        if not m.perturb:
            return None
        return torch.cat([torch.rand((min(tile, n_rays - t0), m.n_samples), generator=self.gen,
                                     device=self.device) for t0 in range(0, n_rays, tile)])


# -------------------------------------------------------------- optimizer

def adam_step(p: torch.Tensor, g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
              count: int, lr: float, clip: float = 40.0, b1: float = 0.9, b2: float = 0.999,
              eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Adam step after clipping each gradient value to +-clip; ``count``
    is the step's number (1 for the first). Returns (p, mu, nu)."""
    g = g.clamp(-clip, clip)
    mu = (1.0 - b1) * g + b1 * mu
    nu = (1.0 - b2) * g * g + b2 * nu
    upd = (mu / (1.0 - b1 ** count)) / (torch.sqrt(nu / (1.0 - b2 ** count)) + eps)
    return p - lr * upd, mu, nu


def exponential_lr(base: float, gamma: float, decay_epochs: int, ep_iter: int, step: int
                   ) -> float:
    """base gamma^(epoch / decay_epochs), epoch = step // ep_iter."""
    return base * gamma ** ((step // ep_iter) / decay_epochs)


# ------------------------------------------------------------- checkpoint

def mlp_paths(m: Model, with_table: bool) -> List[Tuple[Tuple, Tuple[int, ...]]]:
    """(path, shape) of one MLP's leaves in the checkpoints' order: keys
    sorted, lists in order, each layer's b before its w."""
    W, out = m.width, []
    out += [(("alpha_linear", "b"), (1,)), (("alpha_linear", "w"), (W, 1)),
            (("feature_linear", "b"), (W,)), (("feature_linear", "w"), (W, W))]
    fan_in = m.input_ch
    for i in range(m.depth):
        out += [(("pts_linears", i, "b"), (W,)), (("pts_linears", i, "w"), (fan_in, W))]
        fan_in = W + m.input_ch if i in m.skips else W
    out += [(("rgb_linear", "b"), (3,)), (("rgb_linear", "w"), (W // 2, 3)),
            (("views_linears", 0, "b"), (W // 2,)),
            (("views_linears", 0, "w"), (W + m.input_ch_views, W // 2))]
    if with_table:
        T = 1 << m.hash_log2_size
        out.append((("xyz_encoder", "table"), (m.hash_levels, T, m.hash_features)))
    return out


def leaf_paths(m: Model) -> List[Tuple]:
    """Every parameter leaf's path, coarse model first."""
    paths = mlp_paths(m, m.encoder == "hashgrid")
    return [(name,) + p for name in ("coarse", "fine") for p, _ in paths]


def set_path(tree: Dict, path: Sequence, value) -> None:
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append({})
            node = node[key]
        else:
            node = node.setdefault(key, [] if isinstance(nxt, int) else {})
    node[path[-1]] = value


def read_checkpoint(m: Model, path: str, device) -> Dict:
    """A frequency NeRF's Adam checkpoint (``leaf_<i>`` arrays of the whole
    train state): {"params", "mu", "nu"} as {leaf path: float32 tensor},
    "count" (Adam's) and "step" (the schedule's)."""
    paths = leaf_paths(m)
    n = len(paths)
    with np.load(path) as z:
        def leaf(i):
            return torch.from_numpy(np.asarray(z[f"leaf_{i}"], np.float32)).to(device)

        out = {"params": {p: leaf(i) for i, p in enumerate(paths)},
               "count": int(z[f"leaf_{n}"]),
               "mu": {p: leaf(n + 1 + i) for i, p in enumerate(paths)},
               "nu": {p: leaf(2 * n + 1 + i) for i, p in enumerate(paths)},
               "step": int(z[f"leaf_{3 * n + 1}"])}
    for (p, shape), name in zip(mlp_paths(m, False) * 2, paths):
        if tuple(out["params"][name].shape) != shape:
            raise ValueError(f"{path}: {name} has shape {tuple(out['params'][name].shape)}, "
                             f"expected {shape}")
    return out


def as_tree(flat: Dict[Tuple, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, value in flat.items():
        set_path(tree, path, value)
    return tree
