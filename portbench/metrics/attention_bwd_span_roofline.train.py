"""Percent of the attention backward's roofline (bf16 peak) a train step reaches, timed by the CUDA
events of the port's ``taa.attention.bwd`` span over the profiled steps: the layer, whatever implements
it, launch gaps inside it included. None without CUDA."""

from portbench import spans


def read(run):
    return spans.span_roofline(run, "bwd", "taa.attention.bwd", "bfloat16")
