"""Kernels launched on the device a unit of work (a train step, a frame),
from the trace."""


def read(prof):
    return len(prof.trace.kernels) / prof.units
