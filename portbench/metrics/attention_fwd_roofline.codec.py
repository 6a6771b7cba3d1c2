"""Percent of the attention forward's roofline (row 1) a request reaches on the latent's active keys, against the fp32 peak."""

from portbench import readers


def read(run):
    return readers.roofline_share(run, "fwd", ("attn_fwd_partial", "attn_fwd_merge"), "float32")
