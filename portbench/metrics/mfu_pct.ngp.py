"""Instant-NGP's train step's share of the card's bf16 peak: the network's
own forward arithmetic (``counts.ngp``: the hash interpolation and 9,408
multiply-adds a point at the published widths) of every sample the traffic
asks for, three times (forward and backward), over the untraced time of the
same block, in %."""
from portbench.counts import ngp, peaks


def read(prof):
    flops = (prof.work["passes"] * prof.work["forward_points"]
             * ngp.forward_flops_per_point(prof.config))
    return 100.0 * flops / (prof.timed_s * peaks.BF16_FLOPS)
