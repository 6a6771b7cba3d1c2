"""PyTorch/CUDA port of topo_audio_autoencoder_tpu: the codec's eval path
and the train step, with the binary-Gumbel and the Hard Concrete samplers
(fixed or learned stretch) and the straight-through ``hard`` path.

The JAX package stays the reference; this package imports nothing of it
(and not JAX). Entry points run on the CUDA card unless the caller passes
``device="cpu"``. The hand-written kernels on these paths (the masked
cross-attention forward and backward, the binary-Gumbel sampler, the two
Hard Concrete samplers) live in ``csrc/`` and are built on first use.
The data layer (``data/``: WAV preprocessing, the on-card distance
precompute, the contrastive dataset and its prefetch) feeds the train step.
"""

from .data import (
    ContrastiveConfig,
    NSynthDataset,
    batch_iterator,
    compute_distances,
    index_iterator,
    load_distances,
    prefetch_to_device,
    preprocess_split,
    synth_corpus,
)
from .inference import Codec, SimplicialLatent, pack_latent, unpack_latent
from .models import AudioAutoencoder
from .training import (
    LossWeights,
    TrainState,
    anneal_temperature,
    create_train_state,
    make_eval_step,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "AudioAutoencoder",
    "Codec",
    "ContrastiveConfig",
    "LossWeights",
    "NSynthDataset",
    "SimplicialLatent",
    "TrainState",
    "anneal_temperature",
    "batch_iterator",
    "compute_distances",
    "create_train_state",
    "index_iterator",
    "load_distances",
    "make_eval_step",
    "make_optimizer",
    "make_train_step",
    "pack_latent",
    "prefetch_to_device",
    "preprocess_split",
    "synth_corpus",
    "unpack_latent",
]
