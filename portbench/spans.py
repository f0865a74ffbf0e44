"""What the per-layer readers take from the program's own spans and counters
(``nerf_tpu_torch.utils.profiling``), where the program has them.

The program opens its spans only while a profiler runs, so under the
traced block alone. Spans of the thread that runs the profiler are in the
trace (``prof.trace.host``, on the device trace's clock); spans of other
threads, the server's handler threads, only in the program's memory
(``program_spans``), with their root's id.

``idle_split`` puts every instant of the traced window at which the device
is idle (outside the union of its operations) down to the innermost program
span the host was in at that instant (the latest to start, the shortest of
those), cut exactly at every boundary, not by a gap's midpoint. Instants
outside every span go to ``""``. Against a program without spans the
readers return None.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

from . import trace as tracing

# the program's span names (nerf_tpu_torch: train/state.py, ops/fused_mlp.py,
# ops/fused_mlp_bwd.py, render/renderer.py, serve.py)
SPANS = ("train.step", "train.optimizer", "mlp.pack", "mlp.unpack_grads", "rays.sample",
         "serve.request", "serve.lock_wait", "serve.png")

_CACHE = "spans.idle_split"


def split(idle: List[Tuple[float, float]], spans: Iterable[Tuple[str, float, float]]
          ) -> Dict[str, float]:
    """Idle seconds by innermost span: ``idle`` sorted disjoint (start, end)
    spans of idle time, ``spans`` (name, start, end) host ranges."""
    ranges = sorted((s, e, n) for n, s, e in spans if e > s)
    bounds = sorted({x for s, e in idle for x in (s, e)} | {x for s, e, _ in ranges for x in (s, e)})
    out: Dict[str, float] = {}
    active: List[Tuple[float, float, str]] = []
    gi = ri = 0
    for a, b in zip(bounds, bounds[1:]):
        while gi < len(idle) and idle[gi][1] <= a:
            gi += 1
        if gi == len(idle) or idle[gi][0] > a:  # the device is busy in [a, b]
            continue
        while ri < len(ranges) and ranges[ri][0] <= a:
            active.append(ranges[ri])
            ri += 1
        active = [r for r in active if r[1] > a]
        name = max(active, key=lambda r: (r[0], -r[1]))[2] if active else ""
        out[name] = out.get(name, 0.0) + (b - a)
    return out


def idle_split(prof) -> Optional[Tuple[Dict[str, float], float]]:
    """({span: idle s}, all idle s) of the traced window; None when the trace
    holds no program span. Kept in ``prof.extra`` for the other readers."""
    if _CACHE not in prof.extra:
        tr = prof.trace
        spans = [(n, s, e) for n, s, e in tr.host if n in SPANS]
        if not spans:
            prof.extra[_CACHE] = None
        else:
            idle = tracing.gaps(tr.device, 0.0, tr.window_s)
            prof.extra[_CACHE] = (split(idle, spans), sum(e - s for s, e in idle))
    return prof.extra[_CACHE]


def idle_share(prof, names: Iterable[str]) -> Optional[float]:
    """% of the traced window's device-idle time with the host innermost in
    one of ``names``."""
    got = idle_split(prof)
    if got is None or got[1] <= 0.0:
        return None
    by_span, total = got
    return 100.0 * sum(by_span.get(n, 0.0) for n in names) / total


def program_spans() -> Optional[list]:
    """The program's span records, or None where it keeps none."""
    try:
        from nerf_tpu_torch.utils import profiling

        return profiling.spans()
    except (ImportError, AttributeError):
        return None


def program_counters() -> Optional[Dict[str, int]]:
    """The program's counters, or None where it keeps none."""
    try:
        from nerf_tpu_torch.utils import profiling

        return profiling.counters()
    except (ImportError, AttributeError):
        return None


def requests(records) -> List:
    """The ``serve.request`` spans: each request's root."""
    return [r for r in records if r.name == "serve.request"]


def request_share(name: str) -> Optional[float]:
    """% of all ``serve.request`` time spent in spans ``name`` of those
    requests (the spans that share a request's root id)."""
    records = program_spans()
    if not records:
        return None
    roots = {r.id: r for r in requests(records)}
    total = sum(r.end_ns - r.start_ns for r in roots.values())
    if total <= 0:
        return None
    part = sum(r.end_ns - r.start_ns for r in records if r.name == name and r.root in roots)
    return 100.0 * part / total
