"""PyTorch/CUDA port of topo_audio_autoencoder_tpu: the codec's eval path.

The JAX package stays the reference; this package imports nothing of it
(and not JAX). Entry points run on the CUDA card unless the caller passes
``device="cpu"``. The one hand-written kernel on this path, the masked
cross-attention forward, lives in ``csrc/`` and is built on first use.
"""

from .inference import Codec, SimplicialLatent, pack_latent, unpack_latent
from .models import AudioAutoencoder

__all__ = ["AudioAutoencoder", "Codec", "SimplicialLatent", "pack_latent", "unpack_latent"]
