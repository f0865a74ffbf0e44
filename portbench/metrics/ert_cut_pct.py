"""% of the samples given to the compositing kernel (B3) in the traced block
whose weight early ray termination zeroed: MLP work (B1) thrown away. The
program counts both (``b3.ert_cut`` on the device, ``b3.samples`` on the
host) while the profiler runs."""
from portbench import spans


def read(prof):
    counts = spans.program_counters()
    if not counts or not counts.get("b3.samples"):
        return None
    return 100.0 * counts.get("b3.ert_cut", 0) / counts["b3.samples"]
