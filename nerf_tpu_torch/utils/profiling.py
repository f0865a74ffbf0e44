"""Rays/s meter; counterpart of ``RaysPerSecond`` in ``nerf_tpu/utils/profiling.py``.

Each measured block ends in a host copy of its result (the sync the JAX
package uses), with ``torch.cuda.synchronize`` before the timer starts and
after the copy, so a frame's time is its device work, not its enqueue.
The first ``drop_first`` frames (the warm-up) are left out of the summary,
as the reference's run.py does.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import numpy as np
import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


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
