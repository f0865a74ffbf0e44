"""% of rank 0's traced device-idle time during which its host was innermost
in the program's ``train.all_reduce`` span (the gradient all-reduce of
``train/state.py`` ``_global_stats``, waiting for the slowest rank),
split among ``spans.SPANS`` and that span."""
from portbench import spans, trace as tracing

NAMES = spans.SPANS + ("train.all_reduce",)


def read(prof):
    tr = prof.trace
    found = [(n, s, e) for n, s, e in tr.host if n in NAMES]
    if not any(n == "train.all_reduce" for n, _, _ in found):
        return None
    idle = tracing.gaps(tr.device, 0.0, tr.window_s)
    total = sum(e - s for s, e in idle)
    if total <= 0.0:
        return None
    return 100.0 * spans.split(idle, found).get("train.all_reduce", 0.0) / total
