"""Percent of the attention forward's roofline (row 1: csrc/masked_attention_fwd.cu) a train step reaches, against the bf16 peak."""

from portbench import readers


def read(run):
    return readers.roofline_share(run, "fwd", ("attn_fwd_partial", "attn_fwd_merge"), "bfloat16")
