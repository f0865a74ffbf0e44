"""The device's idle share, in %: one minus the union of the device
operations in the traced block (overlaps count once) over the time the
same count of units takes untraced. (The profiler slows the host, so the
traced block's own length would count its overhead as idle.)"""


def read(prof):
    return 100.0 * (1.0 - prof.trace.busy_s / prof.timed_s)
