"""Neighbor exploration: dump a sample's nearest/farthest neighbors as wavs.

Port of ``topo_audio_autoencoder_tpu.data.explore`` (NumPy only): the same
tree and file names. Non-interactive equivalent of the reference ``explore_neighbors``
(reference: main.py:88-176), which the reference gates behind an input()
prompt. Given the packed corpus + the precomputed distance artifacts, it
writes::

    <out_dir>/<index>/
    ├── original.wav
    ├── nearest/neighbor_<k>_dist_<d>.wav ...
    └── farthest/neighbor_<k>_dist_<d>.wav ...
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from .preprocess import save_wav


def explore_neighbors(
    waveforms: np.ndarray,  # [N, T]
    distances: np.ndarray,  # [N, N]
    neighbors: np.ndarray,  # [N, N-1] nearest->farthest
    index: int | None = None,
    out_dir: str | Path = "./neighbor_samples",
    num_neighbors: int = 3,
    sample_rate: int = 16000,
    seed: int = 0,
) -> Path:
    """Returns the directory written for the chosen sample."""
    n = len(waveforms)
    if index is None:
        index = int(np.random.default_rng(seed).integers(0, n))
    order = neighbors[index]
    sample_dir = Path(out_dir) / str(index)
    (sample_dir / "nearest").mkdir(parents=True, exist_ok=True)
    (sample_dir / "farthest").mkdir(parents=True, exist_ok=True)

    save_wav(sample_dir / "original.wav", waveforms[index], sample_rate)
    for i in range(min(num_neighbors, len(order))):
        near = int(order[i])
        d = float(distances[index, near])
        save_wav(
            sample_dir / "nearest" / f"neighbor_{i + 1}_dist_{d:.4f}.wav",
            waveforms[near],
            sample_rate,
        )
        far = int(order[-(i + 1)])
        d = float(distances[index, far])
        save_wav(
            sample_dir / "farthest" / f"neighbor_{i + 1}_dist_{d:.4f}.wav",
            waveforms[far],
            sample_rate,
        )
    return sample_dir
