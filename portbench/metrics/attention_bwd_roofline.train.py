"""Percent of the attention backward's roofline (row 2: csrc/masked_attention_bwd.cu) a train step reaches, against the bf16 peak."""

from portbench import readers


def read(run):
    return readers.roofline_share(run, "bwd", ("attn_bwd_delta", "attn_bwd_dkdv", "attn_bwd_dq_partial", "attn_bwd_dq_merge"), "bfloat16")
