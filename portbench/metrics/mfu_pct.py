"""The whole step's (or frame's) share of the card's bf16 peak: the model's
own forward arithmetic (``counts.nerf_mlp.forward_flops_per_point`` of every
point the traffic asks for; a train step counts it three times, forward and
backward) over the untraced time of the same block, in %."""
from portbench.counts import nerf_mlp, peaks


def read(prof):
    flops = (prof.work["passes"] * prof.work["forward_points"]
             * nerf_mlp.forward_flops_per_point(prof.config))
    return 100.0 * flops / (prof.timed_s * peaks.BF16_FLOPS)
