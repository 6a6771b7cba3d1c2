"""Percent of the bf16 peak: the train step's model FLOPs over the window's time a step."""

from portbench import readers


def read(run):
    return readers.mfu(run)
