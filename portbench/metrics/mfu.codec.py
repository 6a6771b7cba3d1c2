"""Percent of the configuration's peak (TF32, as cuDNN runs the fp32 convolutions): a request's model FLOPs over the window's time a request."""

from portbench import readers


def read(run):
    return readers.mfu(run)
