"""Host ms a train step in the port's loss spans (``taa.loss.*``: the multiscale STFT distance with the
regularizers, and InfoNCE), over the profiled steps; the profiler's own cost per operator is in it."""

from portbench import spans


def read(run):
    return spans.host_ms_per_step("taa.loss.")
