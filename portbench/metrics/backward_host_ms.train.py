"""Host ms a train step in the port's backward span (``taa.train.backward``: ``autograd.grad`` and the
gradients' fp32 conversion), over the profiled steps; the profiler's own cost per operator is in it."""

from portbench import spans


def read(run):
    return spans.host_ms_per_step("taa.train.backward")
