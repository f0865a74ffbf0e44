"""What every driver shares: the run's context, its outcome, the result line.

A driver's ``run(ctx)`` returns an ``Outcome``: the work attempted and
failed, the end-to-end values it measured (``--trace 0``) or the
``Profiled`` block that the per-layer readers read (``--trace 1``), and
each number compared with the reference beside its limit. ``result`` turns
that into the one JSON line: ``correct`` holds when every number is within
its limit and no operation failed; the numbers come last, under ``checks``.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import bench, trace as tracing

FORBIDDEN = ("jax", "jaxlib", "flax", "nerf_tpu")


def log(msg: str) -> None:
    print(f"# {msg}", file=sys.stderr, flush=True)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose of a run, from --seed (any size)."""
    digest = hashlib.sha256(f"{int(seed)}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


@dataclasses.dataclass
class Context:
    cell: bench.Cell
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    t0: float  # the process's first clock reading: set-up starts here
    setup_s: Optional[float] = None

    def seed_for(self, tag: str) -> int:
        return sub_seed(self.seed, tag)

    def mark(self, what: str) -> None:
        """Log how far into set-up ``what`` ended."""
        log(f"set-up: {what} done at {time.perf_counter() - self.t0:.3f} s")

    def window_starts(self) -> None:
        """Set-up ends: loading, building and warm-up are done."""
        self.setup_s = time.perf_counter() - self.t0
        log(f"set-up: {self.setup_s:.3f} s")


@dataclasses.dataclass
class Profiled:
    """A fixed block of steady work, timed without the profiler and then
    traced, that the per-layer readers read."""
    trace: tracing.Trace
    units: int  # steps, frames or requests in the traced block
    timed_s: float  # the same count of units without the profiler
    config: Dict  # the configuration file
    work: Dict  # what the traffic asked of each layer in the traced block
    extra: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    values: Dict[str, float]  # end-to-end values (--trace 0)
    profiled: Optional[Profiled]  # (--trace 1)
    checks: Dict[str, Tuple[float, float]]  # number: (value, limit)
    memory_peak_bytes: int


def timed(fn: Callable[[], object]) -> Tuple[object, float]:
    import torch

    sync = torch.cuda.synchronize if torch.cuda.is_available() else (lambda: None)
    sync()
    t = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t


def check(name: str, value: float, limits: Dict) -> Tuple[str, Tuple[float, float]]:
    return name, (float(value), float(limits[name]))


def colour_gaps(got, want) -> Dict[str, float]:
    """How far colours [..., 3] in [0, 1] lie from the reference's: the RMS
    and mean absolute difference, its median and 99th percentile, and the
    share of values more than 2/255 off."""
    import numpy as np

    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).reshape(-1)
    return {"rmse": float(np.sqrt(np.mean(d * d))), "mae": float(np.mean(d)),
            "p50": float(np.median(d)), "p99": float(np.quantile(d, 0.99)),
            "share_over_2": float(np.mean(d > 2.0 / 255.0))}


def within(checks: Dict[str, Tuple[float, float]]) -> bool:
    return all(math.isfinite(v) and v <= lim for v, lim in checks.values())


def forbidden_modules() -> List[str]:
    """The loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def read_layer_metrics(ctx: Context, prof: Profiled) -> Dict[str, Dict]:
    out = {}
    for spec in ctx.cell.per_layer:
        value = bench.metric_reader(spec["name"], ctx.cell.root).read(prof)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def result(ctx: Context, outcome: Outcome, device_kind: str) -> Dict:
    """The result line as a dict, keys in the contract's order, checks last."""
    if ctx.trace:
        metrics = read_layer_metrics(ctx, outcome.profiled)
    else:
        values = dict(outcome.values, setup_s=ctx.setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in ctx.cell.end_to_end}
    device = {"platform": "gpu", "kind": device_kind, "count": ctx.cell.chips,
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"correct": within(outcome.checks) and outcome.failed == 0,
            "attempted": int(outcome.attempted), "failed": int(outcome.failed),
            "metrics": metrics, "device": device}
    if ctx.trace:
        tr = outcome.profiled.trace
        device.update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tracing.top_ops(tr),
                             "idle_gaps": tracing.idle_by_host(tr)}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in outcome.checks.items()}
    return line


def emit(line: Dict) -> None:
    """The numbers compared as the last lines of stderr, the result as the
    last line of stdout."""
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
