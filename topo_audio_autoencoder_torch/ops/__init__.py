"""Filterbank, samplers, SCCN combine, masked attention and the STFT loss."""

from .attention import (
    MaskedAttention,
    attention_bwd,
    attention_bwd_plain,
    attention_fwd,
    attention_fwd_plain,
    fused_masked_attention,
    reference_attention,
)
from .fused_samplers import (
    binary_gumbel_fused,
    binary_gumbel_fused_diff,
    binary_gumbel_plain,
    binary_gumbel_sample,
    philox_uniform,
)
from .pqmf import PQMF
from .samplers import binary_gumbel, straight_through, temperature_schedule
from .sccn_combine import message_combine_reference
from .stft import multiscale_stft, spectral_distance, stft_magnitude

__all__ = [
    "PQMF",
    "MaskedAttention",
    "attention_bwd",
    "attention_bwd_plain",
    "attention_fwd",
    "attention_fwd_plain",
    "binary_gumbel",
    "binary_gumbel_fused",
    "binary_gumbel_fused_diff",
    "binary_gumbel_plain",
    "binary_gumbel_sample",
    "fused_masked_attention",
    "message_combine_reference",
    "multiscale_stft",
    "philox_uniform",
    "reference_attention",
    "spectral_distance",
    "stft_magnitude",
    "straight_through",
    "temperature_schedule",
]
