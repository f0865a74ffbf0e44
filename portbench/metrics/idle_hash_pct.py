"""% of the traced window's device-idle time during which the host was
innermost in the program's ``hash.encode`` span (the hash encoder's index
arithmetic, its gather and the interpolation, ``render/renderer.py``
``_xyz_embed``), the host's time split among ``spans.SPANS`` and that span."""
from portbench import spans, trace as tracing

NAMES = spans.SPANS + ("hash.encode",)


def read(prof):
    tr = prof.trace
    found = [(n, s, e) for n, s, e in tr.host if n in NAMES]
    if not any(n == "hash.encode" for n, _, _ in found):
        return None
    idle = tracing.gaps(tr.device, 0.0, tr.window_s)
    total = sum(e - s for s, e in idle)
    if total <= 0.0:
        return None
    return 100.0 * spans.split(idle, found).get("hash.encode", 0.0) / total
