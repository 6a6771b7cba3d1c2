"""Encoder, SCCN, decoder and the autoencoder facade."""

from .autoencoder import AudioAutoencoder, AutoencoderOutput
from .decoder import (
    AudioDecoder,
    CrossAttention,
    MaskedGroupNorm,
    linear_resize,
    masked_linear_resize,
    pack_active,
)
from .encoder import (
    AudioEncoder,
    BandEncoder,
    EncoderOutput,
    info_nce_loss,
    rank_diversity_entropy,
    triplet_loss,
    vertex_count_penalty,
)
from .sccn import GradientSCCN, GradientSCCNLayer, JumpingKnowledgeSCCN

__all__ = [
    "AudioAutoencoder",
    "AudioDecoder",
    "AudioEncoder",
    "AutoencoderOutput",
    "BandEncoder",
    "CrossAttention",
    "EncoderOutput",
    "GradientSCCN",
    "GradientSCCNLayer",
    "JumpingKnowledgeSCCN",
    "MaskedGroupNorm",
    "info_nce_loss",
    "linear_resize",
    "masked_linear_resize",
    "pack_active",
    "rank_diversity_entropy",
    "triplet_loss",
    "vertex_count_penalty",
]
