"""The device trace of a block of work, from ``torch.profiler``, kept in memory.

``profile(fn)`` runs ``fn`` under the profiler (CPU and CUDA activities)
inside a marker range and keeps, relative to the marker's start, every
device operation (kernels, copies, memsets) and every host operation. The
device's busy time is the union of the device intervals inside the marker,
so operations that overlap count once (``busy_s``; the marker's length is
``window_s``). Nothing is written to disk.
"""
from __future__ import annotations

import collections
import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

MARK = "portbench.window"

Interval = Tuple[str, float, float]  # (name, start s, end s)


@dataclasses.dataclass
class Trace:
    device: List[Interval]  # every device operation, by start
    host: List[Interval]  # host operations (not the marker)
    window_s: float

    @property
    def kernels(self) -> List[Interval]:
        return [e for e in self.device if not is_copy(e[0])]

    @property
    def busy_s(self) -> float:
        return busy(self.device, 0.0, self.window_s)

    def matching(self, patterns: Sequence[re.Pattern]) -> List[Interval]:
        return [e for e in self.kernels if any(p.search(e[0]) for p in patterns)]


def is_copy(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def merged(intervals: Sequence[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The union of the intervals, clipped to [lo, hi], as sorted disjoint spans."""
    spans: List[List[float]] = []
    for _, s, e in sorted(intervals, key=lambda x: x[1]):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if spans and s <= spans[-1][1]:
            spans[-1][1] = max(spans[-1][1], e)
        else:
            spans.append([s, e])
    return [(s, e) for s, e in spans]


def busy(intervals: Sequence[Interval], lo: float, hi: float) -> float:
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals: Sequence[Interval], lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle spans of [lo, hi] between the merged intervals."""
    out, t = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void``, anonymous namespaces and its
    argument list, at most ``width`` letters."""
    base = name.replace("(anonymous namespace)::", "")
    base = base[5:] if base.startswith("void ") else base
    return (base.split("(")[0].strip() or name)[:width]


def top_ops(tr: Trace, n: int = 10) -> List[List]:
    """The n device operations that took most time, [[name, seconds], ...]."""
    tot: Dict[str, float] = collections.Counter()
    for name, s, e in tr.device:
        tot[short_name(name)] += e - s
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_by_host(tr: Trace, n: int = 10) -> List[List]:
    """The idle time of the device summed by what the host was doing at each
    gap's middle (the innermost host operation that spans it; "host idle"
    where none does), the n largest, [[name, seconds], ...]."""
    import numpy as np

    spans = gaps(tr.device, 0.0, tr.window_s)
    mids = np.array([0.5 * (s + e) for s, e in spans])
    best = np.full(len(spans), np.inf)  # the duration of the innermost op so far
    label = np.full(len(spans), -1)
    for k, (_, s, e) in enumerate(tr.host):
        lo, hi = np.searchsorted(mids, s, "left"), np.searchsorted(mids, e, "right")
        if hi > lo:
            inner = best[lo:hi] > e - s
            best[lo:hi][inner] = e - s
            label[lo:hi][inner] = k
    tot: Dict[str, float] = collections.Counter()
    for (s, e), k in zip(spans, label):
        tot[short_name(tr.host[k][0], 64) if k >= 0 else "host idle"] += e - s
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _from_events(events) -> Tuple[Optional[Tuple[float, float]], List[Interval], List[Interval]]:
    """(marker span, device, host) from the profiler's FunctionEvents, in s."""
    from torch.autograd import DeviceType

    mark, device, host = None, [], []
    for ev in events:
        s, e = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.name == MARK:  # its host range (its device-side copy is no operation)
            if ev.device_type != DeviceType.CUDA:
                mark = (s, e)
        elif ev.device_type == DeviceType.CUDA:
            device.append((ev.name, s, e))
        else:
            host.append((ev.name, s, e))
    return mark, device, host


def profile(fn: Callable[[], object]) -> Tuple[object, Trace]:
    """Run ``fn`` under the profiler, the card idle before and after; returns
    (fn's result, its Trace)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile, record_function

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(MARK):
            out = fn()
            torch.cuda.synchronize()
    mark, device, host = _from_events(prof.events())
    if mark is None or not device:
        raise RuntimeError("the profiler recorded no window marker or no device operation")
    # a host range's device-side copy (a user annotation) is no device operation
    ranges = {n for n, _, _ in host}
    device = [d for d in device if d[0] not in ranges]
    lo = mark[0]
    shift = lambda evs: sorted(((n, s - lo, e - lo) for n, s, e in evs),  # noqa: E731
                               key=lambda x: x[1])
    return out, Trace(device=shift(device), host=shift(host), window_s=mark[1] - mark[0])
