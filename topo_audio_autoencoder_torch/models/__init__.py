"""Encoder, SCCN, decoder and the autoencoder facade."""

from .autoencoder import AudioAutoencoder, AutoencoderOutput
from .decoder import AudioDecoder
from .encoder import AudioEncoder, BandEncoder, EncoderOutput
from .sccn import GradientSCCN, GradientSCCNLayer

__all__ = [
    "AudioAutoencoder",
    "AudioDecoder",
    "AudioEncoder",
    "AutoencoderOutput",
    "BandEncoder",
    "EncoderOutput",
    "GradientSCCN",
    "GradientSCCNLayer",
]
