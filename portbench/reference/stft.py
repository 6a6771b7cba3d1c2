"""Multiscale magnitude STFT and the spectral distance of the training loss.

Centered frames (reflect-pad n_fft//2 on both sides), periodic Hann
window, hop = n_fft // 4, frames made with reshapes and static slices,
magnitudes from ``torch.fft.rfft`` divided by sqrt(n_fft).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_SCALES = (2048, 1024, 512, 256, 128)


def frame_signal(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Overlapping frames via reshape and shift (requires n_fft % hop == 0).

    x: [..., T] -> [..., F, n_fft]; T is right-padded with zeros to a
    multiple of hop.
    """
    if n_fft % hop != 0:
        raise ValueError("n_fft must be a multiple of hop for reshape framing")
    ratio = n_fft // hop
    pad = (-x.shape[-1]) % hop
    if pad:
        x = F.pad(x, (0, pad))
    chunks = x.reshape(*x.shape[:-1], -1, hop)  # [..., T/hop, hop]
    n_frames = chunks.shape[-2] - ratio + 1
    return torch.cat([chunks[..., i : i + n_frames, :] for i in range(ratio)], dim=-1)


def _reflect_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-pad the last axis of [..., T] (torch's reflect mode wants a
    3-d input, and a pad shorter than T)."""
    if pad >= x.shape[-1]:
        raise ValueError(
            f"a reflect pad of {pad} needs a signal longer than {pad} samples, "
            f"not {x.shape[-1]}"
        )
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (pad, pad), mode="reflect")
    return y.reshape(*lead, y.shape[-1])


def stft_magnitude(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """x: [..., T] -> [..., F, n_fft//2 + 1], in the input's dtype."""
    frames = frame_signal(_reflect_pad(x, n_fft // 2), n_fft, n_fft // 4)
    window = torch.from_numpy(np.hanning(n_fft + 1)[:-1]).to(frames.device, x.dtype)
    return torch.fft.rfft(frames * window, dim=-1).abs() / math.sqrt(n_fft)


def _mean_over_nonbatch(v: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    return v.mean(dim=tuple(range(batch_ndim, v.dim())))


def spectral_distance(
    x: torch.Tensor,
    y: torch.Tensor,
    scales=DEFAULT_SCALES,
    log_epsilon: float = 1e-7,
    batch_ndim: int = 1,
) -> torch.Tensor:
    """Batch-preserving AudioDistanceV1: per scale, relative L2 on linear
    magnitudes (normalized by x's energy) plus L1 on log magnitudes, summed
    over scales. Returns [batch...]. Computed in fp32 whatever the input
    dtype (an fp32 island: bf16 magnitudes lose too much of the log term).
    """
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    dist = 0.0
    for s in scales:
        sx = stft_magnitude(x, s)
        sy = stft_magnitude(y, s)
        lin = _mean_over_nonbatch((sx - sy) ** 2, batch_ndim) / (
            _mean_over_nonbatch(sx**2, batch_ndim) + 1e-7
        )
        log = _mean_over_nonbatch(
            torch.abs(torch.log(sx + log_epsilon) - torch.log(sy + log_epsilon)), batch_ndim
        )
        dist = dist + lin + log
    return dist
