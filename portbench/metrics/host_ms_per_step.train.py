"""Host ms in the train step's call (gather, forward, backward, Optimizer.update), waits included: the mean over the window's unprofiled steps."""

from portbench import readers


def read(run):
    return readers.mean_span_ms(run)
