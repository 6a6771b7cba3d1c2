"""Host ms a train step in the port's forward span (``taa.train.forward``: the objective through
``functional_call``), over the profiled steps; the profiler's own cost per operator is in it."""

from portbench import spans


def read(run):
    return spans.host_ms_per_step("taa.train.forward")
