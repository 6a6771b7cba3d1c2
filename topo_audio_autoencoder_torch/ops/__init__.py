"""Filterbank, eval sampler, SCCN combine and masked attention."""

from .attention import (
    attention_fwd,
    attention_fwd_plain,
    fused_masked_attention,
    reference_attention,
)
from .pqmf import PQMF
from .samplers import binary_gumbel
from .sccn_combine import message_combine_reference

__all__ = [
    "PQMF",
    "attention_fwd",
    "attention_fwd_plain",
    "binary_gumbel",
    "fused_masked_attention",
    "message_combine_reference",
    "reference_attention",
]
