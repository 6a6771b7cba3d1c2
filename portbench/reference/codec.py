"""The reference codec: encode (the noiseless relaxation, rectified) to
the wire's bits, and decode from bits, in plain torch, in row blocks."""

from __future__ import annotations

import numpy as np
import torch

from .autoencoder import AudioAutoencoder
from .rectifier import RectifiedProbs


@torch.no_grad()
def encode_bits(model: AudioAutoencoder, clips: torch.Tensor, block: int = 16) -> np.ndarray:
    """[N, 1, T] -> [N, S_total] bool: each simplex's bit (probability
    >= 0.5), ranks concatenated in order."""
    out = []
    for i in range(0, clips.shape[0], block):
        enc = model.encode(clips[i : i + block])
        out.append(torch.cat([r >= 0.5 for r in enc.rectified.ranks], dim=-1).cpu().numpy())
    return np.concatenate(out)


@torch.no_grad()
def decode_bits(model: AudioAutoencoder, bits: np.ndarray, num_samples: int, device, dtype=torch.float32,
                block: int = 16) -> np.ndarray:
    """[N, S_total] bits -> [N, num_samples] float32 waveforms."""
    sizes = model.tables.sizes
    out = []
    for i in range(0, bits.shape[0], block):
        flat = torch.as_tensor(bits[i : i + block], device=device).to(dtype)
        ranks = torch.split(flat, list(sizes), dim=-1)
        wav = model.decode_from_probs(RectifiedProbs(*ranks), num_samples // model.num_bands)
        out.append(wav[:, 0].to(torch.float32).cpu().numpy())
    return np.concatenate(out)
