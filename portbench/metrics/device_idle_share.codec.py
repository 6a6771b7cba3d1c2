"""Percent of the profiled requests' window in which no device op ran."""

from portbench import readers


def read(run):
    return readers.idle_share(run)
