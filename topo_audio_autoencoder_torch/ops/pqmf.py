"""Pseudo-QMF (PQMF) analysis/synthesis filterbank.

Port of ``topo_audio_autoencoder_tpu.ops.pqmf``: a cosine-modulated
near-perfect-reconstruction filterbank splitting a waveform into ``n_band``
critically-sampled subbands and back.

Design (host-side, numpy/scipy, once per process and (attenuation, M)):
a Kaiser-windowed lowpass prototype whose cutoff is optimized for minimum
end-to-end reconstruction error, cosine-modulated into M bands,

    h_k[t] = 2 h[t] cos((2k+1) * (pi/2M) * (t - (N-1)/2) + (-1)^k * pi/4).

Compute: analysis is one strided conv [B,1,T] -> [B,M,T/M] after the
asymmetric zero padding (pad, pad-(M-1)); synthesis is its exact adjoint (a
strided transposed conv, cropped) scaled by M.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sps
from scipy.optimize import minimize_scalar
from torch import nn


def _kaiser_prototype(cutoff: float, attenuation: float, n_band: int) -> np.ndarray:
    """Kaiser-designed linear-phase lowpass prototype (odd length)."""
    width = 1.0 / (2.0 * n_band)  # transition width ~ half band, Nyquist=1
    numtaps, beta = sps.kaiserord(attenuation, width)
    numtaps |= 1  # force odd for exact linear phase / zero delay
    return sps.firwin(numtaps, cutoff, window=("kaiser", beta), fs=2.0)


def _modulate(h: np.ndarray, n_band: int) -> np.ndarray:
    """Cosine-modulate the prototype into the M analysis filters [M, N]."""
    n = h.shape[-1]
    t = np.arange(n) - (n - 1) / 2
    k = np.arange(n_band)[:, None]
    phase = ((-1.0) ** k) * np.pi / 4.0
    return 2.0 * h[None, :] * np.cos((2 * k + 1) * np.pi / (2 * n_band) * t + phase)


def _np_analysis(x: np.ndarray, hk: np.ndarray, n_band: int) -> np.ndarray:
    """Host analysis, x [T] -> [M, T/M] (correlation, zero delay)."""
    n = hk.shape[-1]
    pad = n // 2
    xp = np.pad(x, (pad, pad))
    m, tm = n_band, len(x) // n_band
    out = np.empty((m, tm))
    for band in range(m):
        full = np.correlate(xp, hk[band], mode="valid")  # length T
        out[band] = full[: tm * n_band : n_band]
    return out


def _np_synthesis(z: np.ndarray, hk: np.ndarray, n_band: int) -> np.ndarray:
    """Host synthesis: M * exact adjoint of ``_np_analysis``."""
    m, tm = z.shape
    n = hk.shape[-1]
    t = tm * m
    pad = n // 2
    acc = np.zeros(t)
    for band in range(m):
        up = np.zeros(t)
        up[::n_band] = z[band]
        acc += np.convolve(up, hk[band], mode="full")[pad : pad + t]
    return n_band * acc


def _reconstruction_error(h: np.ndarray, n_band: int) -> float:
    """Steady-state relative L2 reconstruction error on white noise, over
    the signal interior (the first/last 2N samples carry the edge
    transient that would swamp the filter-quality signal)."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(8 * n_band * 64)
    hk = _modulate(h, n_band)
    y = _np_synthesis(_np_analysis(x, hk, n_band), hk, n_band)
    n = h.shape[-1]
    s = slice(2 * n, len(x) - 2 * n)
    return float(np.linalg.norm(y[s] - x[s]) / np.linalg.norm(x[s]))


def design_prototype(attenuation: float, n_band: int) -> tuple[np.ndarray, float]:
    """Optimize the prototype cutoff for minimum reconstruction error.

    Returns (prototype, achieved relative reconstruction error).
    """
    ideal = 1.0 / (2.0 * n_band)

    def objective(c):
        return _reconstruction_error(_kaiser_prototype(c, attenuation, n_band), n_band)

    res = minimize_scalar(
        objective, bounds=(0.5 * ideal, 1.5 * ideal), method="bounded",
        options={"xatol": ideal * 1e-4},
    )
    h = _kaiser_prototype(float(res.x), attenuation, n_band)
    return h, float(res.fun)


@lru_cache(maxsize=8)
def _design_cached(attenuation: float, n_band: int):
    """The cutoff search costs host time per (attenuation, M): cache it
    per process so repeated model creation is free."""
    return design_prototype(attenuation, n_band)


class PQMF(nn.Module):
    """Near-perfect-reconstruction pseudo-QMF filterbank.

    forward: [B, 1, T] -> [B, M, T/M]   (T must be divisible by M)
    inverse: [B, M, T/M] -> [B, 1, T]

    The [M, 1, N] filters are a non-persistent buffer: they follow the
    module's device but are not parameters and not in its state_dict.
    """

    def __init__(self, attenuation: float = 100.0, n_band: int = 16):
        super().__init__()
        h, err = _design_cached(float(attenuation), int(n_band))
        hk = _modulate(h, n_band).astype(np.float32)
        self.attenuation = attenuation
        self.n_band = n_band
        self.recon_error = err
        self.register_buffer("filters", torch.from_numpy(hk)[:, None, :], persistent=False)

    @classmethod
    def create(cls, attenuation: float = 100.0, n_band: int = 16) -> "PQMF":
        """The JAX package's constructor; the same as ``PQMF(attenuation, n_band)``."""
        return cls(attenuation, n_band)

    @property
    def taps(self) -> int:
        return self.filters.shape[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Analysis. x: [B, 1, T] -> [B, M, T/M]."""
        m, n = self.n_band, self.taps
        pad = n // 2
        w = self.filters.to(x.dtype)
        return F.conv1d(F.pad(x, (pad, pad - (m - 1))), w, stride=m)

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        """Synthesis: M * adjoint(analysis). z: [B, M, T/M] -> [B, 1, T]."""
        m, n = self.n_band, self.taps
        pad = n // 2
        t = z.shape[-1] * m
        y = F.conv_transpose1d(z, self.filters.to(z.dtype), stride=m)
        return y[..., pad : pad + t] * float(m)
