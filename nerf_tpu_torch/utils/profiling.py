"""Profiling hooks; counterpart of ``nerf_tpu/utils/profiling.py``.

- ``sync(tree)``: the device synchronised and the tree's last tensor leaf
  copied to the host, the sync the JAX package uses (a no-op on a tree
  without tensors).
- ``trace(log_dir)``: ``torch.profiler`` over a block, CPU activity and,
  where there is a GPU, CUDA activity (each kernel launch by name); on exit
  a Chrome trace (``trace_<pid>_<ns>.json``) is written into ``log_dir``.
- ``memory_stats()``: each CUDA device's bytes in use and their peak, from
  ``torch.cuda.memory_stats``; ``{}`` without a GPU, as the JAX package's
  on the CPU.
- ``RaysPerSecond``: a rays/s meter. Each measured block ends in a host copy
  of its result, with the device synchronised before the timer starts and
  after the copy, so a frame's time is its device work, not its enqueue.
  The first ``drop_first`` frames (the warm-up) are left out of the
  summary, as the reference's run.py does.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..tree import tree_leaves


def _sync() -> None:
    """The device part of ``sync``: wait for the CUDA device's queued work."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def sync(tree) -> None:
    """Synchronise the device and copy the last tensor leaf of ``tree`` (a
    tensor, or a dict/list/tuple tree of them) to the host."""
    leaves = [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]
    if leaves:
        _sync()
        np.asarray(leaves[-1].detach().cpu())


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with ``torch.profiler`` and write its Chrome trace
    into ``log_dir`` (created; by default ``nerf_tpu_torch-trace`` in the
    temporary directory); yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "nerf_tpu_torch-trace")
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield log_dir
    finally:  # the trace is written also when the block raises, as JAX's is
        _sync()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def memory_stats() -> Dict[str, Dict[str, int]]:
    """{"cuda:<i>": {"bytes_in_use", "peak_bytes_in_use"}} for each CUDA
    device whose allocator has stats; {} without a GPU."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        ms = torch.cuda.memory_stats(i)
        if ms:
            out[f"cuda:{i}"] = {"bytes_in_use": int(ms.get("allocated_bytes.all.current", 0)),
                                "peak_bytes_in_use": int(ms.get("allocated_bytes.all.peak", 0))}
    return out


class RaysPerSecond:
    def __init__(self, drop_first: int = 1):
        self.drop_first = drop_first
        self.samples: List[Tuple[int, float]] = []

    @contextlib.contextmanager
    def measure(self, n_rays: int):
        """Time a block; it yields ``done(result)``, whose tensor argument is
        copied to the host before the timer stops."""
        holder = [None]
        _sync()
        t0 = time.perf_counter()
        yield lambda res: holder.__setitem__(0, res)
        if holder[0] is not None:
            np.asarray(holder[0].detach().cpu())
        _sync()
        self.samples.append((n_rays, time.perf_counter() - t0))

    def summary(self) -> Dict[str, float]:
        kept = self.samples[self.drop_first:] or self.samples
        if not kept:
            return {"rays_per_s": 0.0, "mean_time_s": 0.0, "fps": 0.0, "frames": 0}
        total_rays = sum(n for n, _ in kept)
        total_t = sum(t for _, t in kept)
        mean_t = total_t / len(kept)
        return {"rays_per_s": total_rays / total_t if total_t else 0.0,
                "mean_time_s": mean_t, "fps": 1.0 / mean_t if mean_t else 0.0,
                "frames": len(kept)}
