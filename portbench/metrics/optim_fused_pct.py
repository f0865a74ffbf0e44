"""% of the leaves given to the optimizer's step in the traced block that the
multi-tensor Adam kernel updated (``optim.fused_leaves`` over
``optim.leaves``, counted by ``Optimizer.step`` while the profiler runs)."""
from portbench import spans


def read(prof):
    counts = spans.program_counters()
    if not counts or not counts.get("optim.leaves"):
        return None
    return 100.0 * counts.get("optim.fused_leaves", 0) / counts["optim.leaves"]
