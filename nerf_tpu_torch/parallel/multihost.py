"""Rank gating, barriers, broadcasts and gathers; counterpart of ``nerf_tpu/parallel/multihost.py``.

The reference gates checkpoints, evaluation and logging to rank 0 and syncs
ranks with a barrier; the JAX package does it per host with
``jax.process_index`` and ``multihost_utils``. Here a rank is a process of
the ``torch.distributed`` group. Without an initialized group every function
is the identity of the single-process case: rank 0 of 1, no wait, the tree
itself, ``x[None]``. Collectives run on the group's device: the rank's card
under NCCL, the CPU under gloo (gloo also takes CUDA tensors).
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..tree import tree_flatten, tree_unflatten


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if initialized() else 1


def is_main_process() -> bool:
    return process_index() == 0


def _nccl() -> bool:
    return dist.get_backend() == "nccl"


def barrier(name: str = "barrier") -> None:
    """Every rank waits here for the others (``name`` labels the point, as
    in JAX's ``sync_global_devices``)."""
    if not initialized():
        return
    if _nccl():
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def _comm_device(t: torch.Tensor) -> torch.device:
    """Where a leaf travels: NCCL needs the rank's card; gloo takes the
    tensor where it is."""
    if _nccl():
        return torch.device("cuda", torch.cuda.current_device())
    return t.device


def _to_wire(leaf) -> torch.Tensor:
    t = leaf if isinstance(leaf, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(leaf))
    t = t.detach().to(_comm_device(t))
    # bool travels as uint8: not every backend reduces or sends bool
    return (t.to(torch.uint8) if t.dtype == torch.bool else t).contiguous()


def _from_wire(t: torch.Tensor, like):
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t.to(torch.bool if like.dtype == np.bool_ else t.dtype).cpu().numpy()


def broadcast_from_main(tree: Any) -> Any:
    """Rank 0's values of a tree of tensors or numpy arrays, on every rank
    (each rank passes a tree of the same shapes). Returns a new tree; a
    tensor leaf comes back on its own device."""
    if not initialized():
        return tree
    leaves, spec = tree_flatten(tree)
    out = []
    for leaf in leaves:
        leaf = leaf if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        wire = _to_wire(leaf)
        dist.broadcast(wire, src=0)
        out.append(_from_wire(wire, leaf))
    return tree_unflatten(spec, out)


def gather_to_main(x):
    """Every rank's ``x`` stacked on a new leading axis [world, ...], on
    every rank (an all-gather, as JAX's ``process_allgather``); a tensor
    comes back as a tensor on its device, anything else as numpy."""
    if not initialized():
        return x[None] if isinstance(x, torch.Tensor) else np.asarray(x)[None]
    like = x if isinstance(x, torch.Tensor) else np.asarray(x)
    wire = _to_wire(like)
    parts = [torch.empty_like(wire) for _ in range(process_count())]
    dist.all_gather(parts, wire)
    stacked = torch.stack(parts)
    if isinstance(like, torch.Tensor):
        return stacked.to(device=like.device, dtype=like.dtype)
    return _from_wire(stacked, like)
