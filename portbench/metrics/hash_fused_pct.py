"""% of the points the hash encoder encoded in the traced block that took its
fused kernels (``hash.fused_points`` over ``hash.points``, counted by
``models/hashgrid.py``'s ``hashgrid_encode`` while the profiler runs). A
program without those counters reads nothing."""
from portbench import spans


def read(prof):
    counts = spans.program_counters()
    if not counts or not counts.get("hash.points"):
        return None
    return 100.0 * counts.get("hash.fused_points", 0) / counts["hash.points"]
