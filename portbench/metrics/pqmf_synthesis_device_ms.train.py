"""Stream ms a train step in the port's PQMF synthesis: the CUDA event intervals of the spans
``taa.pqmf.synthesis`` (the decoder's last stage, ``PQMF.inverse``) and ``taa.pqmf.synthesis_bwd`` (its
backward), summed over the profiled steps, over the count of ``taa.train.step``. Neither span nests in the
other: autograd runs the backward after the forward's span has closed. An interval runs from the stream
reaching the span's first event to its reaching the second, so it holds the span's kernels and any gap
the host leaves between them. None without CUDA or where the spans record no events (a port whose
synthesis span takes none, and has no backward span)."""

from portbench import spans

NAMES = ("taa.pqmf.synthesis", "taa.pqmf.synthesis_bwd")


def read(run):
    recorded = spans.recorded()
    if not recorded or spans.ROOT not in recorded:
        return None
    device_s = [recorded[name]["device_s"] for name in NAMES if name in recorded and recorded[name]["device_s"]]
    return 1e3 * sum(device_s) / recorded[spans.ROOT]["count"] if device_s else None
