"""Seconds of the run's process in the port's PQMF design search (set-up span ``taa.setup.pqmf_design``,
once per process and design)."""

from portbench import spans


def read(run):
    return spans.setup_seconds("taa.setup.pqmf_design")
