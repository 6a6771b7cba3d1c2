"""Host ms a train step in the port's optimizer span (``taa.train.optimizer``: the clip and the per-leaf
Adam), over the profiled steps; the profiler's own cost per operator is in it."""

from portbench import spans


def read(run):
    return spans.host_ms_per_step("taa.train.optimizer")
