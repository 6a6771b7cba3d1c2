"""Host ms of Codec.decode and the waveform's copy to the host, the mean over the window's unprofiled requests."""

from portbench import readers


def read(run):
    return readers.mean_span_ms(run, 3)
