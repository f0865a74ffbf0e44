"""B2's share of its roofline: the bound of the backward of every MLP batch
the traced steps ask for (``counts.b2``) over the time of B2's kernels in
the trace, in %."""
from portbench import bench
from portbench.counts import b2


def read(prof):
    spent = sum(e - s for _, s, e in prof.trace.matching(bench.kernel_patterns("b2")))
    if spent <= 0.0:
        return None
    return 100.0 * b2.bound_s(prof.work["mlp_calls"], prof.config) / spent
