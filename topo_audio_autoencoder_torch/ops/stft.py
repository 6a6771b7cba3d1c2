"""Multiscale magnitude STFT and the spectral distance of the training loss.

Port of ``topo_audio_autoencoder_tpu.ops.stft`` (``frame_signal``,
``stft_magnitude``, ``multiscale_stft``, ``spectral_distance``,
``spectral_distance_matrix_block``).
Conventions, as in the JAX package:

- centered frames: reflect-pad n_fft//2 on both sides,
- Hann window (periodic), hop = n_fft // 4, frames made with reshapes and
  static slices (no gather),
- magnitudes divided by sqrt(n_fft).

Three methods compute the magnitudes: ``fft`` (``torch.fft.rfft``),
``matmul`` (the windowed real DFT as two matrix products, the JAX
package's choice on a TPU) and ``hybrid`` (an rfft forward whose backward
is two matrix products against the unwindowed DFT basis). ``auto`` takes
``fft`` on every device, as the JAX package does off the TPU.
"""

from __future__ import annotations

import math
from functools import lru_cache

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


@lru_cache(maxsize=16)
def _windowed_dft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Hann-windowed real-DFT basis [n_fft, n_fft//2+1] (cos, -sin)."""
    k = np.arange(n_fft // 2 + 1)
    t = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(t, k) / n_fft
    w = np.hanning(n_fft + 1)[:-1]
    return (
        (np.cos(ang) * w[:, None]).astype(np.float32),
        (-np.sin(ang) * w[:, None]).astype(np.float32),
    )


@lru_cache(maxsize=16)
def _dft_matrices(n_fft: int) -> tuple[np.ndarray, np.ndarray]:
    """Unwindowed real-DFT basis [n_fft, n_fft//2+1] (cos, -sin)."""
    k = np.arange(n_fft // 2 + 1)
    t = np.arange(n_fft)
    ang = 2.0 * np.pi * np.outer(t, k) / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


class _MagHybrid(torch.autograd.Function):
    """|rfft(fw)| / sqrt(n), in fw's dtype, with a backward of two matrix
    products against the DFT basis:
        d|S|/dfw = (re * ct) @ C^T + (im * ct) @ S^T, scaled by 1/sqrt(n),
    where (re, im) is the unit phase (re, im) / (|S| + 1e-24) saved by the
    forward (the JAX package's ``_mag_hybrid``)."""

    @staticmethod
    def forward(ctx, fw: torch.Tensor, n_fft: int) -> torch.Tensor:
        spec = torch.fft.rfft(fw.to(torch.float32), dim=-1)
        mag_un = spec.abs()
        inv = 1.0 / (mag_un + 1e-24)
        ctx.save_for_backward(spec.real * inv, spec.imag * inv)
        ctx.n_fft = n_fft
        return (mag_un / math.sqrt(n_fft)).to(fw.dtype)

    @staticmethod
    def backward(ctx, ct: torch.Tensor):
        re_u, im_u = ctx.saved_tensors
        cos_b, nsin_b = (torch.from_numpy(m).to(ct.device) for m in _dft_matrices(ctx.n_fft))
        ctf = ct.to(torch.float32) * (1.0 / math.sqrt(ctx.n_fft))
        g = (ctf * re_u) @ cos_b.T + (ctf * im_u) @ nsin_b.T
        return g.to(ct.dtype), None


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


def stft_magnitude(
    x: torch.Tensor, n_fft: int, hop: int | None = None, method: str = "auto"
) -> torch.Tensor:
    """Centered, Hann-windowed, normalized magnitude STFT.

    x: [..., T] -> [..., F, n_fft//2 + 1], in the input's dtype.
    """
    hop = hop or n_fft // 4
    frames = frame_signal(_reflect_pad(x, n_fft // 2), n_fft, hop)
    if method == "auto":
        method = "fft"
    if method == "matmul":
        cos_b, nsin_b = (
            torch.from_numpy(m).to(frames.device) for m in _windowed_dft_matrices(n_fft)
        )
        f32 = frames.to(torch.float32)
        re = f32 @ cos_b
        im = f32 @ nsin_b
        mag = torch.sqrt(re * re + im * im + 1e-24)
        return (mag / math.sqrt(n_fft)).to(frames.dtype)
    if method not in ("fft", "hybrid"):
        raise ValueError(f"method must be 'auto', 'fft', 'matmul' or 'hybrid', not {method!r}")
    window = torch.from_numpy(np.hanning(n_fft + 1)[:-1]).to(frames.device, x.dtype)
    if method == "hybrid":
        return _MagHybrid.apply(frames * window, n_fft)
    spec = torch.fft.rfft(frames * window, dim=-1)
    return spec.abs() / math.sqrt(n_fft)


def multiscale_stft(x: torch.Tensor, scales=DEFAULT_SCALES, method: str = "auto") -> list:
    """Magnitude STFTs at each scale (hop = scale/4). x: [..., T]."""
    return [stft_magnitude(x, s, method=method) for s in scales]


def _mean_over_nonbatch(v: torch.Tensor, batch_ndim: int) -> torch.Tensor:
    return v.mean(dim=tuple(range(batch_ndim, v.dim())))


def spectral_distance(
    x: torch.Tensor,
    y: torch.Tensor,
    scales=DEFAULT_SCALES,
    log_epsilon: float = 1e-7,
    batch_ndim: int = 1,
    method: str = "auto",
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
        sx = stft_magnitude(x, s, method=method)
        sy = stft_magnitude(y, s, method=method)
        lin = _mean_over_nonbatch((sx - sy) ** 2, batch_ndim) / (
            _mean_over_nonbatch(sx**2, batch_ndim) + 1e-7
        )
        log = _mean_over_nonbatch(
            torch.abs(torch.log(sx + log_epsilon) - torch.log(sy + log_epsilon)), batch_ndim
        )
        dist = dist + lin + log
    return dist


def spectral_distance_matrix_block(xs: torch.Tensor, ys: torch.Tensor, scales=DEFAULT_SCALES) -> torch.Tensor:
    """Pairwise spectral distances between two stacks of waveforms.

    xs: [A, T], ys: [B, T] -> [A, B], entry (a, b) the ``spectral_distance``
    of xs[a] (the reference) and ys[b]. Each stack's multiscale STFT is
    computed once here. Per scale:
    - the relative-L2 term expands to ||x||² + ||y||² - 2<x, y>, one
      [A, FK] @ [FK, B] product, clamped at 0;
    - the L1 log term cannot factor through a product, so it runs over
      chunks of 8,192 of the flattened F*K axis, both sides zero-padded to
      a whole chunk (a padded position adds |0 - 0|): each chunk
      broadcasts [A, B, 8192] and adds into the [A, B] result.
    """
    xs = xs.to(torch.float32)
    ys = ys.to(torch.float32)
    out = 0.0
    chunk = 8192
    for s in scales:
        fx = stft_magnitude(xs, s).reshape(xs.shape[0], -1)  # [A, FK]
        fy = stft_magnitude(ys, s).reshape(ys.shape[0], -1)  # [B, FK]
        n_elem = fx.shape[-1]
        x2 = (fx * fx).sum(-1)
        y2 = (fy * fy).sum(-1)
        sq = torch.clamp(x2[:, None] + y2[None, :] - 2.0 * (fx @ fy.T), min=0.0)
        lin = (sq / n_elem) / (x2[:, None] / n_elem + 1e-7)

        pad = (-n_elem) % chunk
        lx = F.pad(torch.log(fx + 1e-7), (0, pad))
        ly = F.pad(torch.log(fy + 1e-7), (0, pad))
        log_sum = torch.zeros(fx.shape[0], fy.shape[0], dtype=torch.float32, device=fx.device)
        for c0 in range(0, lx.shape[-1], chunk):
            cx, cy = lx[:, c0 : c0 + chunk], ly[:, c0 : c0 + chunk]
            log_sum += (cx[:, None, :] - cy[None, :, :]).abs().sum(-1)
        out = out + lin + log_sum / n_elem
    return out
