"""Expert-parallel KiloNeRF: the tiny networks sharded over the ranks; counterpart of ``nerf_tpu/parallel/kilonerf_ep.py``.

KiloNeRF's many small MLPs are shaped like a mixture of experts: rank r
holds networks [r G/D, (r + 1) G/D) (``shard_kilonerf_params``), and
``kilonerf_eval_ep`` runs JAX's algorithm on each rank's rows of the points:

1. each point's network and its owner rank (networks are blocked
   contiguously);
2. the points packed into a [D, C_send] buffer by owner, in
   ``ops.kilonerf.dispatch``'s layout (stable rank; a point past C_send is
   dropped), and exchanged with ``all_to_all_single``;
3. the received points routed among the rank's own networks, at most
   ``expert_capacity`` a network, and evaluated with ``mlp_grouped``
   (``eval_routed``, one round, slots only for the networks it serves);
4. the results sent home with the autograd form of ``all_to_all_single``
   (gradients reach the owner's parameters) and unpacked to point order.

Semantics are single-round, as JAX's: an overflowing point returns zeros,
and ``cfg.dispatch_rounds`` is not honoured; size the capacities instead.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from ..ops.kilonerf import (LAYERS, KiloConfig, assign_networks, dispatch, encode, eval_routed,
                            global_to_local, n_networks)
from .mesh import DataGroup

Params = Dict[str, Dict[str, torch.Tensor]]


def shard_kilonerf_params(params: Params, group: DataGroup) -> Params:
    """This rank's networks of each [G, ...] leaf, [r G/D, (r + 1) G/D), as
    leaves of its own (requiring grad as the full leaf does)."""
    out = {}
    for k in LAYERS:
        G = params[k]["w"].shape[0]
        if G % group.world:
            raise ValueError(f"G={G} networks not divisible by {group.world} ranks")
        lo, hi = group.rank * G // group.world, (group.rank + 1) * G // group.world
        out[k] = {n: t[lo:hi].detach().clone().requires_grad_(t.requires_grad)
                  for n, t in params[k].items()}
    return out


def _exchange(x: torch.Tensor) -> torch.Tensor:
    """Slice d of x [D, ...] to rank d; returns what the ranks sent here,
    slice s from rank s (JAX's tiled all_to_all over axis 0)."""
    out = torch.empty_like(x)
    if x.requires_grad:
        return dist_fn.all_to_all_single(out, x.contiguous())
    dist.all_to_all_single(out, x.contiguous())
    return out


def kilonerf_eval_ep(params: Params, pts: torch.Tensor, dirs: torch.Tensor, cfg: KiloConfig,
                     group: DataGroup, send_capacity: int = 0,
                     expert_capacity: int = 0) -> torch.Tensor:
    """This rank's points pts, dirs [P/D, 3] (``shard_batch``) and networks
    (``shard_kilonerf_params``) -> raw [P/D, 4]. Equals ``kilonerf_eval``
    where the capacities suffice; a point that overflows either capacity
    returns zeros. Capacities <= 0 take JAX's defaults: send = max(8,
    capacity_factor P_loc / D), expert = max(8, capacity_factor D send /
    G_loc). Every rank must call it (collectives)."""
    D = group.world
    G = n_networks(cfg)
    if G % D:
        raise ValueError(f"G={G} networks not divisible by {D} ranks")
    G_loc = G // D
    C = send_capacity if send_capacity > 0 else max(8, int(cfg.capacity_factor
                                                            * pts.shape[0] / D))
    if expert_capacity <= 0:
        expert_capacity = max(8, int(cfg.capacity_factor * D * C / G_loc))

    ids = assign_networks(pts, cfg)
    dest = ids // G_loc
    slot, gather_idx, slot_valid = dispatch(dest, D, C)
    flat_gi = gather_idx.reshape(-1)
    valid = slot_valid.reshape(-1, 1)
    payload = torch.cat([global_to_local(pts, ids, cfg), dirs], -1)[flat_gi]
    send = torch.where(valid, payload, torch.zeros_like(payload)).view(D, C, 6)
    send_id = torch.where(slot_valid.reshape(-1), (ids % G_loc)[flat_gi],
                          torch.full_like(flat_gi, G_loc)).view(D, C)

    recv = _exchange(send).reshape(D * C, 6)
    recv_id = _exchange(send_id).reshape(D * C)  # G_loc marks an empty slot

    # route among the local networks: padding (id G_loc) goes nowhere
    real = torch.nonzero(recv_id < G_loc).squeeze(1)
    raw_real = eval_routed(params, encode(recv[real, :3], recv[real, 3:], cfg), recv_id[real],
                           G_loc, expert_capacity, 1, cfg)
    raw_flat = raw_real.new_zeros(D * C, 4).index_put((real,), raw_real)
    if torch.is_grad_enabled() and not raw_flat.requires_grad and any(
            t.requires_grad for layer in params.values() for t in layer.values()):
        # a rank that received no point still takes part in the backward's
        # exchange, which every rank must join
        raw_flat = raw_flat + 0.0 * params[LAYERS[-1]]["b"].sum()
    raw_home = _exchange(raw_flat.view(D, C, 4)).reshape(D * C, 4)

    ok = (slot >= 0)[:, None]
    back = raw_home[dest * C + slot.clamp(min=0)]
    return torch.where(ok, back, torch.zeros_like(back))
