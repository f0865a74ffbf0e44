"""% of the hash table's elements given to the optimizer in the traced block
that took no step because their gradient was exactly 0 (``adam.skipped``,
counted on the device by the Adam kernel, over ``adam.elements``, counted on
the host; both only while the profiler runs)."""
from portbench import spans


def read(prof):
    counts = spans.program_counters()
    if not counts or not counts.get("adam.elements"):
        return None
    return 100.0 * counts.get("adam.skipped", 0) / counts["adam.elements"]
