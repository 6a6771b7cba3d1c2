"""Stream ms a train step in the port's packed-operator spans (``taa.packed.*``: the top-K select, the
face gather and its backward, the face scatter, the packed embeddings and their backward): the sum of
their CUDA event pairs' intervals over the count of ``taa.train.step`` in the profiled steps. No such span
nests in another, so each interval counts once. An interval runs from the stream reaching the span's
first event to its reaching the second: it holds the span's kernels and, where the host issues them
more slowly than the card runs them, the gaps between them, so in a host-bound step it reads above the
kernels' own time. The face scatter's backward, which autograd issues as a product, lies outside every
span. None without CUDA or where the port has no such span."""

from portbench import spans


def read(run):
    recorded = spans.recorded()
    if not recorded or spans.ROOT not in recorded:
        return None
    device_s = [e["device_s"] for name, e in recorded.items() if name.startswith("taa.packed.") and e["device_s"]]
    return 1e3 * sum(device_s) / recorded[spans.ROOT]["count"] if device_s else None
