"""Host ms a train step in the port's packed-operator spans (``taa.packed.*``: the top-K select, the
face gather and its backward, the face scatter, the packed embeddings and their backward), inclusive,
over the profiled steps; the profiler's own cost per operator is in it. The face scatter's backward,
which autograd issues as a product, lies outside every span. None where the port has no such span."""

from portbench import spans


def read(run):
    return spans.host_ms_per_step("taa.packed.")
