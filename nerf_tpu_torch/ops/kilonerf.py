"""KiloNeRF: a g^3 grid of tiny MLPs routed by voxel; counterpart of ``nerf_tpu/ops/kilonerf.py``.

Each point goes to the network of its voxel (``assign_networks``, x-major),
in that network's local [-1, 1]^3 coordinates (``global_to_local``). A
network serves at most ``capacity`` points a round: round r serves the
points of rank [r C, (r + 1) C) within their network, the rank being the
stable one (points keep their input order within a network). Points past
``dispatch_rounds`` rounds return raw 0 (empty space), as in the JAX package.

Each network (hidden width h): freq(local, 10) [63] -> h -> h -> [feat h |
sigma] -> concat(feat, freq(dir, 4) [27]) -> h -> rgb(3); raw = [rgb, sigma].

The tiny MLPs run as ``torch.bmm`` over [networks, slots, in] x [networks,
in, out] in float32 (JAX computes the same grouped product as an XLA einsum,
not a Pallas kernel). The products of the forward and of the backward run in
full float32 whatever the process's TF32 setting (``_GroupedLinear``, one
place for the whole precision policy). JAX's block-diagonal packing of 4
networks a product only aligns its shapes to the TPU's matrix unit; it
changes the order of sums, not the function, so the port does not copy it.

``kilonerf_eval`` (``eval_routed``) serves exactly the windows of the JAX
package's ``_dispatch`` but lays out slots only for the networks a round
serves (``round_window``), with as many slots as the round's fullest network
needs, and stops at the first round that serves no point: the slots it
leaves out are the ones JAX fills with point 0 and discards. ``dispatch``
is JAX's [G, C] layout itself, which the expert-parallel exchange
(``parallel/kilonerf_ep.py``) packs its send buffer by.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch

from ..models.encoders import freq_encode, freq_out_dim
from .precision import full_float32, matmul_precision  # noqa: F401 (tests and chip_smoke.py read both here)

Params = Dict[str, Dict[str, torch.Tensor]]
LAYERS = ("l1", "l2", "l3", "l4", "l5")


class KiloConfig(NamedTuple):
    grid_size: int = 16  # g -> G = g^3 networks
    hidden: int = 32
    xyz_freqs: int = 10  # on the local coordinates
    dir_freqs: int = 4
    bbox_min: float = -2.0
    bbox_max: float = 2.0
    capacity_factor: float = 2.0
    # round r serves the rank window [r C, (r + 1) C) of each network
    dispatch_rounds: int = 1


def n_networks(cfg: KiloConfig) -> int:
    return cfg.grid_size ** 3


def layer_shapes(cfg: KiloConfig) -> Dict[str, tuple]:
    """(in, out) of each layer; l3's last output column is sigma."""
    h = cfg.hidden
    return {"l1": (freq_out_dim(3, cfg.xyz_freqs), h), "l2": (h, h), "l3": (h, h + 1),
            "l4": (h + freq_out_dim(3, cfg.dir_freqs), h), "l5": (h, 3)}


def init_kilonerf(generator: torch.Generator, cfg: KiloConfig,
                  device: Optional[torch.device] = None) -> Params:
    """Leaves l1..l5, each {"w": [G, in, out], "b": [G, out]} float32, drawn
    U(-1/sqrt(in), 1/sqrt(in)) from ``generator`` (a CPU generator), as the
    JAX package's ``_linear_init`` per network."""
    G = n_networks(cfg)
    out = {}
    for name, (fi, fo) in layer_shapes(cfg).items():
        bound = 1.0 / fi ** 0.5
        w = torch.empty(G, fi, fo).uniform_(-bound, bound, generator=generator)
        b = torch.empty(G, fo).uniform_(-bound, bound, generator=generator)
        out[name] = {"w": w.to(device), "b": b.to(device)}
    return out


def assign_networks(pts: torch.Tensor, cfg: KiloConfig) -> torch.Tensor:
    """pts [P, 3] -> network ids [P] int64 (voxel index, x-major)."""
    g = cfg.grid_size
    x = (pts - cfg.bbox_min) / (cfg.bbox_max - cfg.bbox_min)
    v = torch.clamp((x * g).to(torch.int32), 0, g - 1).long()
    return v[..., 0] * g * g + v[..., 1] * g + v[..., 2]


def global_to_local(pts: torch.Tensor, ids: torch.Tensor, cfg: KiloConfig) -> torch.Tensor:
    """Affine map of each point into its network's [-1, 1]^3 cube."""
    g = cfg.grid_size
    cell = (cfg.bbox_max - cfg.bbox_min) / g
    v = torch.stack([ids // (g * g), (ids // g) % g, ids % g], -1).to(pts.dtype)
    corner = cfg.bbox_min + v * cell
    return (pts - corner) / cell * 2.0 - 1.0


def rank_in_network(ids: torch.Tensor, G: int) -> torch.Tensor:
    """The stable rank of each point within its network: the number of
    earlier points with the same id (one stable sort, then each id's first
    position subtracted)."""
    P = ids.shape[0]
    order = torch.sort(ids, stable=True).indices
    counts = torch.bincount(ids, minlength=G)
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(P, device=ids.device) - start[ids[order]]
    rank = torch.empty_like(pos)
    rank[order] = pos
    return rank


def round_window(ids: torch.Tensor, rank: torch.Tensor, counts: torch.Tensor, max_load: int,
                 lo: int, capacity: int):
    """The slots of the round that serves the rank window [lo, lo + capacity)
    of each network (``counts`` the networks' loads, ``max_load`` their
    largest, > lo), laid out for the networks it serves only. Returns
    (active [A] the networks with a point in the window, in id order;
    sel [n] the points served, in input order; flat [n] the slot of each in
    the round's [A, cr] layout; cr slots a network, as many as the round's
    fullest network needs). Slot ``flat % cr`` of network ``active[flat //
    cr]`` is the JAX package's ``_dispatch`` slot of the point."""
    G = counts.shape[0]
    active = torch.nonzero(counts > lo).squeeze(1)
    cr = min(capacity, max_load - lo)
    slot_of = torch.full((G,), -1, dtype=torch.long, device=ids.device)
    slot_of[active] = torch.arange(active.shape[0], device=ids.device)
    sel = torch.nonzero((rank >= lo) & (rank < lo + capacity)).squeeze(1)
    return active, sel, slot_of[ids[sel]] * cr + (rank[sel] - lo), cr


class _GroupedLinear(torch.autograd.Function):
    """x [G, C, in] @ w [G, in, out] + b [G, out], with the products of the
    forward and of the backward in full float32 (``full_float32``)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        with full_float32():
            return torch.baddbmm(b[:, None, :], x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        with full_float32():
            if ctx.needs_input_grad[0]:
                gx = torch.bmm(g, w.transpose(1, 2))
            if ctx.needs_input_grad[1]:
                gw = torch.bmm(x.transpose(1, 2), g)
        if ctx.needs_input_grad[2]:
            gb = g.sum(1)
        return gx, gw, gb


def _layer(x: torch.Tensor, layer: Dict[str, torch.Tensor]) -> torch.Tensor:
    return _GroupedLinear.apply(x, layer["w"], layer["b"])


def mlp_grouped(params: Params, xg: torch.Tensor, dg: torch.Tensor, cfg: KiloConfig,
                encoded: bool = False) -> torch.Tensor:
    """The tiny MLPs over grouped slots: xg, dg [G, C, 3] local coordinates
    and directions (``encoded``: their frequency embeddings [G, C, 63] and
    [G, C, 27]) -> raw [G, C, 4]; network g of ``params`` serves row g."""
    emb_x = xg if encoded else freq_encode(xg, cfg.xyz_freqs)
    emb_d = dg if encoded else freq_encode(dg, cfg.dir_freqs)
    h = torch.relu(_layer(emb_x, params["l1"]))
    h = torch.relu(_layer(h, params["l2"]))
    out3 = _layer(h, params["l3"])
    feat, sigma = out3[..., :cfg.hidden], out3[..., cfg.hidden:]
    h = torch.relu(_layer(torch.cat([feat, emb_d], -1), params["l4"]))
    rgb = _layer(h, params["l5"])
    return torch.cat([rgb, sigma], -1)


def default_capacity(n_points: int, cfg: KiloConfig) -> int:
    """Slots a network a round: capacity_factor x the mean load, at least 8."""
    return max(8, int(cfg.capacity_factor * n_points / n_networks(cfg)))


def no_drop_capacity(pts: torch.Tensor, cfg: KiloConfig) -> int:
    """A capacity under which one round serves every point: the largest
    per-network load of ``pts`` (at least 8)."""
    ids = assign_networks(pts, cfg)
    return max(8, int(torch.bincount(ids, minlength=n_networks(cfg)).max()))


def served_per_round(pts: torch.Tensor, cfg: KiloConfig, capacity: int = 0) -> list:
    """Points served in each of ``cfg.dispatch_rounds`` rounds (the rest are
    dropped): sum over networks of min(C, max(0, load - r C))."""
    capacity = capacity if capacity > 0 else default_capacity(pts.shape[0], cfg)
    counts = torch.bincount(assign_networks(pts, cfg), minlength=n_networks(cfg))
    return [int((counts - r * capacity).clamp(0, capacity).sum())
            for r in range(max(1, int(cfg.dispatch_rounds)))]


def dispatch(ids: torch.Tensor, G: int, capacity: int):
    """The JAX package's ``_dispatch`` layout (one round, the rank window
    [0, capacity)): ids [P] in [0, G] (G marks a row that goes nowhere) ->
    (slot [P], the point's slot in its group or -1 when dropped;
    gather_idx [G, capacity] the point in each slot, 0 for an empty one;
    slot_valid [G, capacity]). Points keep their input order within a
    group (the stable rank)."""
    real = ids < G
    rank = rank_in_network(torch.where(real, ids, G), G + 1)
    slot = torch.where(real & (rank < capacity), rank, -1)
    kept = torch.nonzero(slot >= 0).squeeze(1)
    flat = ids[kept] * capacity + slot[kept]
    gather_idx = torch.zeros(G * capacity, dtype=torch.long, device=ids.device)
    gather_idx[flat] = kept
    slot_valid = torch.zeros(G * capacity, dtype=torch.bool, device=ids.device)
    slot_valid[flat] = True
    return slot, gather_idx.view(G, capacity), slot_valid.view(G, capacity)


def eval_routed(params: Params, emb: torch.Tensor, ids: torch.Tensor, G: int, capacity: int,
                rounds: int, cfg: KiloConfig) -> torch.Tensor:
    """Encoded points emb [P, 63 + 27] (local position, direction) through
    the networks ``ids`` [P] in [0, G) of ``params`` (G networks), at most
    ``capacity`` points a network a round for ``rounds`` rounds -> raw
    [P, 4], exactly 0 for a point that no round serves."""
    P = emb.shape[0]
    rank = rank_in_network(ids, G)
    counts = torch.bincount(ids, minlength=G)
    nx = freq_out_dim(3, cfg.xyz_freqs)
    out = emb.new_zeros(P, 4)
    max_load = int(counts.max()) if P else 0
    for r in range(max(1, int(rounds))):
        lo = r * capacity
        if max_load <= lo:
            break  # ranks are contiguous: no later round serves a point either
        active, sel, flat, cr = round_window(ids, rank, counts, max_load, lo, capacity)
        gather = torch.zeros(active.shape[0] * cr, dtype=torch.long, device=emb.device)
        gather[flat] = sel  # empty slots evaluate point 0; nothing reads them
        embg = emb[gather].view(active.shape[0], cr, -1)
        sub = {k: {"w": params[k]["w"][active], "b": params[k]["b"][active]} for k in LAYERS}
        raw = mlp_grouped(sub, embg[..., :nx], embg[..., nx:], cfg, encoded=True)
        out = out.index_put((sel,), raw.reshape(-1, 4)[flat])
        del embg, raw, sub, gather
    return out


def encode(local: torch.Tensor, dirs: torch.Tensor, cfg: KiloConfig) -> torch.Tensor:
    """[P, 3] local positions and directions -> their frequency encodings
    [P, 63 + 27], before any slot gather: the gather then moves 90-wide
    rows and the sin/cos run on the P points, not on the slots."""
    return torch.cat([freq_encode(local, cfg.xyz_freqs), freq_encode(dirs, cfg.dir_freqs)], -1)


def kilonerf_eval(params: Params, pts: torch.Tensor, dirs: torch.Tensor,
                  cfg: KiloConfig = KiloConfig(), capacity: int = 0) -> torch.Tensor:
    """pts, dirs [P, 3] -> raw [P, 4] (rgb_raw, sigma_raw). A point that no
    round serves (its rank >= dispatch_rounds x capacity) stays exactly 0.
    ``capacity`` <= 0: ``default_capacity``. Differentiable in ``params``."""
    C = capacity if capacity > 0 else default_capacity(pts.shape[0], cfg)
    ids = assign_networks(pts, cfg)
    emb = encode(global_to_local(pts, ids, cfg), dirs, cfg)
    return eval_routed(params, emb, ids, n_networks(cfg), C, cfg.dispatch_rounds, cfg)


def kilonerf_naive(params: Params, pts: torch.Tensor, dirs: torch.Tensor, cfg: KiloConfig,
                   dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """Every point through its own network with no routing machinery (no
    capacity, no drops): the reference the dispatch is held to. The local
    coordinates are the routing's own (in the points' dtype); the encodings
    and the layers run in ``dtype``. [P, 3] -> [P, 4]."""
    ids = assign_networks(pts, cfg)
    local = global_to_local(pts, ids, cfg).to(dtype)
    x = freq_encode(local, cfg.xyz_freqs)
    d = freq_encode(dirs.to(dtype), cfg.dir_freqs)

    def lin(name, h):
        w, b = params[name]["w"][ids].to(dtype), params[name]["b"][ids].to(dtype)
        return torch.einsum("pi,pio->po", h, w) + b

    h = torch.relu(lin("l2", torch.relu(lin("l1", x))))
    o3 = lin("l3", h)
    rgb = lin("l5", torch.relu(lin("l4", torch.cat([o3[:, :cfg.hidden], d], -1))))
    return torch.cat([rgb, o3[:, cfg.hidden:]], -1)


def query_network_kilonerf(params: Params, pts: torch.Tensor, viewdirs: torch.Tensor,
                           cfg: KiloConfig = KiloConfig()) -> torch.Tensor:
    """The renderer's query: pts [N, S, 3], viewdirs [N, 3] -> raw [N, S, 4]."""
    n, s, _ = pts.shape
    dirs = viewdirs[:, None, :].expand(n, s, 3).reshape(-1, 3)
    return kilonerf_eval(params, pts.reshape(-1, 3), dirs, cfg).reshape(n, s, 4)
