"""Host ms of Codec.encode to the latent on the device (synchronized), the mean over the window's unprofiled requests."""

from portbench import readers


def read(run):
    return readers.mean_span_ms(run, 1)
