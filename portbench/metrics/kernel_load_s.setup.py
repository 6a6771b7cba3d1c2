"""Seconds of the run's process in the first load of the port's kernel libraries (set-up span
``taa.setup.kernel_load``), a build included where the checkout had none."""

from portbench import spans


def read(run):
    return spans.setup_seconds("taa.setup.kernel_load")
