"""Kernels a train step launches, from the profiled steps."""

from portbench import readers


def read(run):
    return readers.launches_per_call(run)
