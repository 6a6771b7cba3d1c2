"""Synthetic NSynth-like corpus for tests and benchmarks.

A copy of ``topo_audio_autoencoder_tpu.data.synthetic`` (NumPy only; the
port keeps its own, as importing the JAX package imports JAX): the same
seed gives the same bits. Harmonically structured tones shaped like NSynth
notes (4 s @ 16 kHz, one pitched note with an attack/decay envelope), so
that spectral distances are meaningful without a dataset download.
"""

from __future__ import annotations

import numpy as np


def synth_note(
    rng: np.random.Generator,
    n_samples: int = 64000,
    sr: int = 16000,
) -> np.ndarray:
    """One random harmonic note with attack/decay envelope + light noise."""
    f0 = rng.uniform(80.0, 1000.0)
    t = np.arange(n_samples) / sr
    n_harm = int(min(10, (sr / 2) // f0))
    amps = rng.dirichlet(np.ones(max(n_harm, 1)))
    wave = sum(
        a * np.sin(2 * np.pi * f0 * (h + 1) * t + rng.uniform(0, 2 * np.pi))
        for h, a in enumerate(amps)
    )
    attack = rng.uniform(0.005, 0.1)
    decay = rng.uniform(0.5, 3.0)
    env = np.minimum(t / attack, 1.0) * np.exp(-t / decay)
    wave = wave * env + 0.001 * rng.standard_normal(n_samples)
    return (wave / (np.abs(wave).max() + 1e-9) * 0.8).astype(np.float32)


def synth_corpus(
    n: int, n_samples: int = 64000, sr: int = 16000, seed: int = 0
) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.stack([synth_note(rng, n_samples, sr) for _ in range(n)])
