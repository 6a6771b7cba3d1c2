"""Data layer: preprocessing, on-device distance precompute, datasets."""

from .dataset import (
    ContrastiveConfig,
    NSynthDataset,
    batch_iterator,
    index_iterator,
    prefetch_to_device,
)
from .precompute import (
    compute_distance_matrix,
    compute_distances,
    load_distances,
    sort_neighbors,
)
from .explore import explore_neighbors
from .preprocess import load_split, load_wav, preprocess_split, save_wav
from .synthetic import synth_corpus, synth_note

__all__ = [
    "explore_neighbors",
    "ContrastiveConfig",
    "NSynthDataset",
    "batch_iterator",
    "index_iterator",
    "prefetch_to_device",
    "compute_distance_matrix",
    "compute_distances",
    "load_distances",
    "sort_neighbors",
    "load_split",
    "load_wav",
    "preprocess_split",
    "save_wav",
    "synth_corpus",
    "synth_note",
]
