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

Spans and counters inside the program, on only while a torch profiler runs
in the process (``torch.profiler.profile``, ``trace`` above); the profiler
is the switch, and nothing else turns them on:

- ``span(name)``: a context manager, or a decorator, around a region of
  host code. Off, it costs one flag check. On, it keeps a ``SpanRecord``
  (name, start and end from ``time.perf_counter_ns``, its id, its parent's
  and its root's id, the thread) in a bounded buffer, so every span of one
  request shares its root's id; in a thread that the profiler records, it
  also opens ``record_function(name)``, so the span sits in the profiler's
  trace on the device trace's clock. A span times the host's enqueue and
  never synchronises: device time comes from the device trace.
- ``count(name, n)``: a host counter, under the same switch.
- ``spans()``, ``counters()`` (the host counters, the ``ops/`` launch
  counters, the compositing kernel's device count of samples cut by early
  ray termination and the Adam kernel's of elements its zero-gradient skip
  left; reading those counts synchronises), ``reset()``.
- ``idle_by_span(device, spans, lo, hi)``: the device's idle time in
  [lo, hi] split by the innermost span the host was in at each instant.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import os
import tempfile
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

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


# --- spans and counters ---------------------------------------------------

MAX_SPANS = 1 << 16  # records kept; later ones are counted in ``dropped``


class SpanRecord(NamedTuple):
    name: str
    start_ns: int  # time.perf_counter_ns()
    end_ns: int
    id: int
    parent: Optional[int]  # None for a root
    root: int  # the id of the outermost span of this thread's stack
    thread: int  # threading.get_ident()


_records: List[SpanRecord] = []
_counts: Dict[str, int] = {}
_dropped = [0]
_lock = threading.Lock()
_ids = itertools.count(1)
_local = threading.local()


def enabled() -> bool:
    """Whether spans and counters record: a torch profiler runs in the
    process (in any thread)."""
    return _autograd_profiler._is_profiler_enabled


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _decorate(name: str, fn):
    @functools.wraps(fn)
    def spanned(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return spanned


class _Off:
    """A span that records nothing, one a name, shared by every call."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None

    def __call__(self, fn):
        return _decorate(self.name, fn)


_off: Dict[str, _Off] = {}


class _Span:
    __slots__ = ("name", "id", "parent", "root", "start", "annotation")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        self.parent = stack[-1].id if stack else None
        self.root = stack[0].id if stack else self.id
        stack.append(self)
        # a range in the trace only where the profiler records this thread:
        # elsewhere its device-side annotation would come without its host range
        self.annotation = None
        if torch._C._autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(self.name)
            self.annotation.__enter__()
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _stack().pop()  # spans nest within a thread: this one is on top
        rec = SpanRecord(self.name, self.start, end, self.id, self.parent, self.root,
                         threading.get_ident())
        with _lock:
            if len(_records) < MAX_SPANS:
                _records.append(rec)
            else:
                _dropped[0] += 1
        return False

    def __call__(self, fn):
        return _decorate(self.name, fn)


def span(name: str):
    """A span named ``name``: ``with span(name): ...`` or ``@span(name)``
    (the decorated function opens a span at each call)."""
    if not _autograd_profiler._is_profiler_enabled:
        try:
            return _off[name]
        except KeyError:
            return _off.setdefault(name, _Off(name))
    return _Span(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the host counter ``name`` (while spans are on)."""
    if _autograd_profiler._is_profiler_enabled:
        with _lock:
            _counts[name] = _counts.get(name, 0) + int(n)


def spans() -> List[SpanRecord]:
    """The kept records, in the order their spans ended."""
    with _lock:
        return list(_records)


def dropped() -> int:
    """Records not kept since the last ``reset``: the buffer was full."""
    return _dropped[0]


def counters() -> Dict[str, int]:
    """The host counters; each ``ops/`` kernel's launches
    (``launches.<wrapper>``); ``b3.ert_cut``, the compositing kernel's count
    of the samples whose weight early ray termination zeroed while spans
    were on, and ``adam.skipped``, the Adam kernel's count of the elements
    its zero-gradient skip left (device reads: they synchronise)."""
    from ..ops import adam, fused_mlp, fused_mlp_bwd, hash_gather, integrate

    with _lock:
        out = dict(_counts)
    for fn in (fused_mlp.fused_nerf_eval, fused_mlp.fused_nerf_eval_f32,
               fused_mlp_bwd.fused_nerf_bwd, fused_mlp_bwd.fused_nerf_bwd_f32,
               hash_gather.gather_rows, hash_gather.scatter_add_rows, integrate.integrate,
               adam.adam):
        out[f"launches.{fn.__name__}"] = int(getattr(fn, "launches", 0))
    cut = integrate.ert_cut_count()
    if cut is not None:
        out["b3.ert_cut"] = cut
    skipped = adam.skipped_count()
    if skipped is not None:
        out["adam.skipped"] = skipped
    return out


def reset() -> None:
    """Forget the records, the host counters and the device counts (the
    launch counters stay: their readers take differences)."""
    from ..ops import adam, integrate

    with _lock:
        _records.clear()
        _counts.clear()
        _dropped[0] = 0
    integrate.ert_cut_reset()
    adam.skipped_reset()


def idle_by_span(device: Iterable[Tuple[float, float]],
                 spans: Sequence[Tuple[str, float, float]], lo: float, hi: float
                 ) -> Tuple[Dict[str, float], float]:
    """The device's idle time in [lo, hi] (outside the union of the
    ``device`` intervals (start, end)) split exactly by the innermost of
    ``spans`` (name, start, end) that the host was in at each instant: the
    latest to start, the shortest of those. Returns ({name: idle s}, with
    ``""`` for idle time outside every span, and the total idle s)."""
    busy: List[List[float]] = []
    for s, e in sorted(device):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    idle, t = [], lo
    for s, e in busy:
        if s > t:
            idle.append((t, s))
        t = max(t, e)
    if hi > t:
        idle.append((t, hi))
    ranges = sorted((max(s, lo), min(e, hi), n) for n, s, e in spans if min(e, hi) > max(s, lo))
    bounds = sorted({x for s, e in idle for x in (s, e)} | {x for s, e, _ in ranges for x in (s, e)})
    out: Dict[str, float] = {}
    active: List[Tuple[float, float, str]] = []
    gi = ri = 0
    for a, b in zip(bounds, bounds[1:]):
        while gi < len(idle) and idle[gi][1] <= a:
            gi += 1
        if gi == len(idle) or idle[gi][0] > a:  # busy here
            continue
        while ri < len(ranges) and ranges[ri][0] <= a:
            active.append(ranges[ri])
            ri += 1
        active = [r for r in active if r[1] > a]
        name = max(active, key=lambda r: (r[0], -r[1]))[2] if active else ""
        out[name] = out.get(name, 0.0) + (b - a)
    return out, sum(e - s for s, e in idle)
