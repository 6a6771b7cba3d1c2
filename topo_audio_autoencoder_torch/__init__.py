"""PyTorch/CUDA port of topo_audio_autoencoder_tpu: the codec's eval path,
the train step, with the binary-Gumbel and the Hard Concrete samplers
(fixed or learned stretch) and the straight-through ``hard`` path, and the
training shell around it.

The JAX package stays the reference; this package imports nothing of it
(and not JAX, optax or Orbax). Entry points run on the CUDA card unless the
caller passes ``device="cpu"`` (``train.device=cpu`` on the command line).
The hand-written kernels on these paths (the masked cross-attention forward
and backward, the binary-Gumbel sampler, the two Hard Concrete samplers,
the fused SCCN combine) live in ``csrc/`` and are built on first use.
The data layer (``data/``: WAV preprocessing, the on-card distance
precompute, the contrastive dataset and its prefetch) feeds the train step;
``training/`` holds the steps (plain, corpus-indexed, scanned), the
``Trainer`` (epochs, validation, early stopping, the grid tuner,
checkpoints and resume) and ``CheckpointManager``; ``main`` runs it all:
``python -m topo_audio_autoencoder_torch.main [section.key=value ...]``.
"""

from . import ops, topology
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
from .inference import Codec, SimplicialLatent, load_params, pack_latent, save_params, unpack_latent
from .models import AudioAutoencoder
from .training import (
    CheckpointManager,
    LossWeights,
    MetricWriter,
    Trainer,
    TrainerConfig,
    TrainingMetrics,
    TrainState,
    anneal_temperature,
    create_train_state,
    make_eval_step,
    make_indexed_train_step,
    make_optimizer,
    make_scan_indexed_train_step,
    make_scan_train_step,
    make_train_step,
)

__all__ = [
    "AudioAutoencoder",
    "CheckpointManager",
    "Codec",
    "ContrastiveConfig",
    "LossWeights",
    "MetricWriter",
    "NSynthDataset",
    "SimplicialLatent",
    "TrainState",
    "Trainer",
    "TrainerConfig",
    "TrainingMetrics",
    "anneal_temperature",
    "batch_iterator",
    "compute_distances",
    "create_train_state",
    "index_iterator",
    "load_distances",
    "load_params",
    "make_eval_step",
    "make_indexed_train_step",
    "make_optimizer",
    "make_scan_indexed_train_step",
    "make_scan_train_step",
    "make_train_step",
    "pack_latent",
    "prefetch_to_device",
    "preprocess_split",
    "save_params",
    "synth_corpus",
    "unpack_latent",
]
