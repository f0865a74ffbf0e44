"""B4's share of its roofline: the bytes every gather of the traced steps
must move whatever its indices (``counts.b4``: each index and each gathered
row; the distinct rows left out, so the share can only read low) at HBM's
peak, over B4's kernel time in the trace (``kernels/b4.json``), in %."""
from portbench import bench
from portbench.counts import b4, hashgrid


def read(prof):
    calls = prof.work.get("hash_calls") or []
    spent = sum(e - s for _, s, e in prof.trace.matching(bench.kernel_patterns("b4")))
    if not calls or spent <= 0.0:
        return None
    return 100.0 * b4.bound_s(calls, hashgrid.row_bytes(prof.config)) / spent
