"""Host ms of pack_latent and unpack_latent, the mean over the window's unprofiled requests."""

from portbench import readers


def read(run):
    return readers.mean_span_ms(run, 2)
