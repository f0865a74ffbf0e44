"""The data mesh over ``torch.distributed``; counterpart of ``nerf_tpu/parallel/mesh.py``.

JAX's trainer shards each step's rays over a 1-D ``data`` mesh of devices,
replicates the parameters, and XLA's psum sums the gradients. Here a rank
is one process with one device: ``cuda:LOCAL_RANK`` under NCCL, the CPU
under gloo (the counterpart of XLA's virtual CPU devices). ``DataGroup``
stands for the mesh: the world, this rank and its device; ``shard_batch``
takes a rank's contiguous ``n / world`` rows of a global batch (what
``P("data")`` gives); ``replicate`` broadcasts rank 0's values;
``all_reduce_mean`` averages gradients over the ranks in one float32
buffer. ``launch`` starts the ranks of a ``python -m`` module, rendezvousing
through a ``file://`` store of its own.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..tree import tree_flatten, tree_unflatten
from . import multihost

# the init method that ``launch`` hands its ranks (torchrun's env:// otherwise)
INIT_ENV = "NERF_TPU_TORCH_INIT"


@dataclasses.dataclass(frozen=True)
class DataGroup:
    """The ``data`` mesh: ``world`` ranks, this one ``rank``, on ``device``.
    ``owned``: this process created the process group (and destroys it)."""
    world: int
    rank: int
    device: torch.device
    owned: bool = False

    def rows(self, n: int) -> slice:
        """This rank's contiguous rows of a batch of ``n`` (n % world == 0)."""
        if n % self.world:
            raise ValueError(f"a batch of {n} does not split over {self.world} ranks")
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)


def rank_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (modulo the cards present,
    so that ranks may share a card), made current before any collective;
    the CPU as asked."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    idx = dev.index if dev.index is not None else (
        int(os.environ.get("LOCAL_RANK", 0)) % torch.cuda.device_count())
    torch.cuda.set_device(idx)
    return torch.device("cuda", idx)


def free_port() -> int:
    """A free TCP port on localhost."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_distributed(coordinator: Optional[str] = None,
                     device: Optional[Union[str, torch.device]] = None,
                     backend: Optional[str] = None) -> bool:
    """``init_process_group`` for this rank: NCCL on CUDA, gloo on the CPU
    (``backend`` overrides), the init method ``coordinator``, else the
    launcher's (``INIT_ENV``), else torchrun's ``env://``; world and rank
    from ``WORLD_SIZE`` and ``RANK`` (a lone process without them is rank 0
    of 1 on a free local port). A no-op when a group is already up.
    Returns whether this call created the group."""
    if multihost.initialized():
        return False
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    method = coordinator or os.environ.get(INIT_ENV)
    if method is None and "MASTER_ADDR" in os.environ:
        method = "env://"
    world = int(os.environ.get("WORLD_SIZE", 1))
    rank = int(os.environ.get("RANK", 0))
    if method is None:
        if world != 1:
            raise RuntimeError("WORLD_SIZE > 1 with no init method: start the ranks with "
                               "torchrun or nerf_tpu_torch.parallel.mesh.launch")
        method = f"tcp://localhost:{free_port()}"
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=method, world_size=world, rank=rank, **kwargs)
    return True


def data_group(device: Optional[Union[str, torch.device]] = None,
               owned: bool = False) -> Optional[DataGroup]:
    """The DataGroup of the initialized process group (None without one)."""
    if not multihost.initialized():
        return None
    return DataGroup(world=dist.get_world_size(), rank=dist.get_rank(),
                     device=rank_device(device), owned=owned)


def mesh_world(n_rays: int, n_devices: int, mesh_devices="all") -> int:
    """JAX's ``make_train_mesh`` rule: the device count, capped by
    ``mesh_devices``, lowered until it divides the ray batch."""
    n = n_devices if mesh_devices == "all" else min(n_devices, int(mesh_devices))
    n = max(1, n)
    while n_rays % n:
        n -= 1
    return n


def device_count(device: torch.device, mesh_devices="all") -> int:
    """The devices a trainer may span: the visible cards on CUDA; on the CPU
    as many gloo ranks as ``mesh_devices`` asks for (1 for "all")."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return 1 if mesh_devices == "all" else int(mesh_devices)


def shard_batch(group: Optional[DataGroup], x):
    """This rank's contiguous ``n / world`` rows of each tensor of ``x`` (a
    tensor or a tree of them); the batch itself without a group."""
    if group is None:
        return x
    leaves, spec = tree_flatten(x)
    return tree_unflatten(spec, [t[group.rows(t.shape[0])] for t in leaves])


def replicate(group: Optional[DataGroup], x):
    """Rank 0's values of ``x`` (a tensor or a tree of tensors) on every
    rank, written into ``x``'s own tensors (an optimizer keeps referring to
    them); returns ``x``."""
    if group is not None:
        with torch.no_grad():
            for dst, src in zip(tree_flatten(x)[0],
                                tree_flatten(multihost.broadcast_from_main(x))[0]):
                dst.copy_(src)
    return x


def all_reduce_mean(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The mean over the ranks of each tensor, through one all-reduce of one
    float32 buffer: each tensor flattened and widened to float32 (so that a
    bf16 leaf is summed in float32 and rounded once, not at every add),
    summed, divided by the world size and cast back to its dtype. The
    tensors themselves without a process group."""
    if not multihost.initialized():
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    out, i = [], 0
    for t in tensors:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def destroy(group: Optional[DataGroup]) -> None:
    """Destroy the process group if ``group`` created it."""
    if group is not None and group.owned and multihost.initialized():
        dist.destroy_process_group()


def launch(module: str, args: Sequence[str], world: int, device_type: str,
           log_dir: Optional[str] = None, timeout: Optional[float] = None) -> None:
    """Run ``python -m module *args`` as ``world`` ranks (RANK, LOCAL_RANK,
    WORLD_SIZE set, a fresh ``file://`` store as their init method) and wait
    for all of them. On the CPU each rank gets ``cpu_count / world`` threads
    unless ``OMP_NUM_THREADS`` is set. ``log_dir``: each rank's output goes
    to ``rank<r>.log`` there. Raises ``RuntimeError`` naming the first rank
    that fails (the others are stopped) or when ``timeout`` seconds pass."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    rdv = tempfile.mkdtemp(prefix="rendezvous_")
    base = dict(os.environ)
    base.update({INIT_ENV: "file://" + os.path.join(rdv, "store"), "WORLD_SIZE": str(world),
                 "LOCAL_WORLD_SIZE": str(world),
                 "PYTHONPATH": os.pathsep.join(filter(None, [root, base.get("PYTHONPATH")]))})
    if device_type == "cpu":
        base.setdefault("OMP_NUM_THREADS", str(max(1, (os.cpu_count() or 1) // world)))
    procs, logs = [], []
    try:
        for r in range(world):
            out = open(os.path.join(log_dir, f"rank{r}.log"), "w") if log_dir else None
            logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", module, *args], env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
                stdout=out, stderr=subprocess.STDOUT if out else None, stdin=subprocess.DEVNULL))
        t0 = time.monotonic()
        while True:
            codes = [p.poll() for p in procs]
            failed = [(r, c) for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0][0]} of {world} ({module}) exited with "
                                   f"code {failed[0][1]}")
            if all(c == 0 for c in codes):
                return
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise RuntimeError(f"{module} at world {world} did not finish in {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out in logs:
            if out is not None:
                out.close()
        shutil.rmtree(rdv, ignore_errors=True)
