"""B1's share of its roofline: the bound of every MLP launch the traced
frames ask for (``counts.b1``) over B1's kernel time in the trace, in %."""
from portbench import bench
from portbench.counts import b1


def read(prof):
    spent = sum(e - s for _, s, e in prof.trace.matching(bench.kernel_patterns("b1")))
    if spent <= 0.0:
        return None
    return 100.0 * b1.bound_s(prof.work["mlp_calls"], prof.config) / spent
