"""B4''s share of its roofline: the bytes the scatter-add of every traced
step's table gradient must read (``counts.b4_bwd``: each index and each
cotangent row) at HBM's peak, over the time of its kernels in the trace
(``kernels/b4_bwd.json``), in %. The gradient's zeroing is a memset, a
copy-engine operation outside those kernels, so its bytes (the table's)
are left out of the bound with its time."""
from portbench import bench
from portbench.counts import b4_bwd, hashgrid


def read(prof):
    calls = prof.work.get("scatter_calls") or []
    spent = sum(e - s for _, s, e in prof.trace.matching(bench.kernel_patterns("b4_bwd")))
    if not calls or spent <= 0.0:
        return None
    return 100.0 * b4_bwd.bound_s(calls, hashgrid.row_bytes(prof.config), 0) / spent
