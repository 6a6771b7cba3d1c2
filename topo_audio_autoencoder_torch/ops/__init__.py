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
from .fused_hard_concrete import (
    hard_concrete_fused,
    hard_concrete_fused_diff,
    hard_concrete_fused_learned,
    hard_concrete_fused_learned_diff,
    hard_concrete_learned_plain,
    hard_concrete_learned_sample,
    hard_concrete_plain,
    hard_concrete_sample,
)
from .fused_samplers import (
    binary_gumbel_fused,
    binary_gumbel_fused_diff,
    binary_gumbel_plain,
    binary_gumbel_sample,
    philox_uniform,
)
from .pqmf import PQMF, design_prototype
from .samplers import (
    HardConcreteParams,
    bernoulli_ste,
    binary_gumbel,
    hard_concrete,
    hard_concrete_l0_penalty,
    straight_through,
    temperature_schedule,
)
from .sccn_combine import combine_bwd, combine_fwd, fused_message_combine, message_combine_reference
from .stft import (
    DEFAULT_SCALES,
    multiscale_stft,
    spectral_distance,
    spectral_distance_matrix_block,
    stft_magnitude,
)

__all__ = [
    "DEFAULT_SCALES",
    "HardConcreteParams",
    "PQMF",
    "MaskedAttention",
    "attention_bwd",
    "attention_bwd_plain",
    "attention_fwd",
    "attention_fwd_plain",
    "bernoulli_ste",
    "binary_gumbel",
    "binary_gumbel_fused",
    "binary_gumbel_fused_diff",
    "binary_gumbel_plain",
    "binary_gumbel_sample",
    "combine_bwd",
    "combine_fwd",
    "design_prototype",
    "fused_masked_attention",
    "fused_message_combine",
    "hard_concrete",
    "hard_concrete_fused",
    "hard_concrete_fused_diff",
    "hard_concrete_fused_learned",
    "hard_concrete_fused_learned_diff",
    "hard_concrete_l0_penalty",
    "hard_concrete_learned_plain",
    "hard_concrete_learned_sample",
    "hard_concrete_plain",
    "hard_concrete_sample",
    "message_combine_reference",
    "multiscale_stft",
    "philox_uniform",
    "reference_attention",
    "spectral_distance",
    "spectral_distance_matrix_block",
    "stft_magnitude",
    "straight_through",
    "temperature_schedule",
]
