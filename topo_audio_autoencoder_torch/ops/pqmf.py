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
strided transposed conv, cropped) scaled by M. On CPU tensors the synthesis
is that transposed conv; on CUDA tensors it is the polyphase product of the
hand-written kernels ``csrc/pqmf_synthesis.cu`` (``PQMFSynthesis``, the
adjoint kernel its backward): each output frame of M samples is M times the
sum, over the I frame offsets that reach it, of an input frame times an
M x M slice of the tap table ``synthesis_table`` (the taps rounded to the
input's type, re-indexed), summed in fp64 and rounded once to the input's
type, written only where kept.
``synthesis_plain`` and ``synthesis_adjoint_plain`` are the kernels' plain
versions, the same index arithmetic in torch.

Spans and counters (``utils.profiling``): ``taa.pqmf.analysis`` and
``taa.pqmf.synthesis`` round each call of the filterbank (the synthesis with
its CUDA event pair), ``taa.pqmf.synthesis_bwd`` each backward of the
kernel path, and the counter ``pqmf.synthesis_kernel`` counts the syntheses
that took it; the design's search is the set-up span
``taa.setup.pqmf_design``, once per process and (attenuation, M).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from scipy import signal as sps
from scipy.optimize import minimize_scalar
from torch import nn

from ..utils.profiling import count, setup_span, span
from .attention import fold_vmapped
from .fused_samplers import launch_checked

# The synthesis kernels' constants (csrc/pqmf_synthesis.cu; the wrapper
# refuses a library built with others): threads a block, frames a thread,
# frame offsets a step (the table's offsets are a multiple of it), and the
# shared memory a block may take; the types they are built for.
THREADS, FRAMES, CHUNK = 128, 8, 4
MAX_SHARED_BYTES = 232_448
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def synthesis_offsets(n_band: int, taps: int) -> tuple[int, int]:
    """(I, s) of the synthesis's tap table: output frame q reads input
    frames q + s - i for i < I, I rounded up to a multiple of CHUNK (the
    rows past the taps are zero)."""
    pad = taps // 2
    shift = (n_band - 1 + pad) // n_band
    reach = (taps - 1 - pad) // n_band
    return -(-(shift + reach + 1) // CHUNK) * CHUNK, shift


def synthesis_table(filters: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The tap table H [I, M, M] fp32 on the host, from the filters [M, 1, N]
    rounded to ``dtype``: ``H[i, k, r] = h_k[M (i - s) + r + N // 2]``, 0
    outside the taps. Exact: each tap is in ``dtype``."""
    m, taps = filters.shape[0], filters.shape[-1]
    offsets, shift = synthesis_offsets(m, taps)
    h = filters.detach().reshape(m, taps).to("cpu", dtype).to(torch.float32)
    t = (torch.arange(offsets)[:, None] - shift) * m + torch.arange(m) + taps // 2  # [I, r]
    inside = (t >= 0) & (t < taps)
    table = torch.where(inside, h[:, t.clamp(0, taps - 1)], 0.0)  # [k, I, r]
    return table.permute(1, 0, 2).contiguous()


def synthesis_plain(frames: torch.Tensor, table: torch.Tensor, shift: int) -> torch.Tensor:
    """The synthesis kernel's plain version: frames [B, L, M] -> y [B, L, M],
    ``y[q] = M * sum_i frames[q + s - i] @ table[i]``, frames outside
    [0, L) zero."""
    offsets, m = table.shape[0], table.shape[-1]
    windows = F.pad(frames, (0, 0, offsets - 1 - shift, shift)).unfold(1, offsets, 1)  # [B, L, k, I - 1 - i]
    return torch.einsum("blke,ekr->blr", windows, table.flip(0).to(frames.dtype)) * float(m)


def synthesis_adjoint_plain(grad: torch.Tensor, table: torch.Tensor, shift: int) -> torch.Tensor:
    """The adjoint kernel's plain version: the output's gradient [B, L, M]
    -> the frames' [B, L, M], ``g[j] = M * sum_i grad[j - s + i] @ table[i].T``."""
    offsets, m = table.shape[0], table.shape[-1]
    windows = F.pad(grad, (0, 0, shift, offsets - 1 - shift)).unfold(1, offsets, 1)  # [B, L, r, i]
    return torch.einsum("blre,ekr->blk", windows, table.to(grad.dtype)) * float(m)


def synthesis_shared_bytes(n_band: int, offsets: int) -> int:
    """Shared memory a block of the synthesis kernels takes: its tile of
    frames with their halo in fp64, and the table in fp32. A thread owns 4,
    2 or 1 outputs (the largest that divides M) of FRAMES frames."""
    groups = n_band // (4 if n_band % 4 == 0 else 2 if n_band % 2 == 0 else 1)
    tile = THREADS // groups * FRAMES
    return 8 * n_band * (tile + offsets) + 4 * offsets * n_band * n_band


def check_synthesis_kernel(n_band: int, offsets: int, dtype: torch.dtype) -> None:
    """Raise ValueError for a synthesis the kernels do not take: a type
    other than fp32 and bf16, or a block over MAX_SHARED_BYTES."""
    if dtype not in _DTYPE_CODES:
        raise ValueError(f"the PQMF synthesis kernels take float32 or bfloat16, not {dtype}")
    need = synthesis_shared_bytes(n_band, offsets)
    if need > MAX_SHARED_BYTES:
        raise ValueError(f"the PQMF synthesis at {n_band} bands and {offsets} frame offsets needs {need} bytes "
                         f"of shared memory a block, over the kernels' limit of {MAX_SHARED_BYTES}")


@lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/pqmf_synthesis.cu, built on first use."""
    from ..cuda_build import load

    lib = load("pqmf_synthesis")
    limits = lib.pqmf_synthesis_limits
    limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
    limits.restype = None
    got = [ctypes.c_int() for _ in range(4)]
    limits(*got)
    if [v.value for v in got] != [THREADS, FRAMES, CHUNK, MAX_SHARED_BYTES]:
        raise RuntimeError(f"csrc/pqmf_synthesis.cu was built with (threads, frames, chunk, shared bytes) "
                           f"{[v.value for v in got]}, the wrapper checks with "
                           f"{[THREADS, FRAMES, CHUNK, MAX_SHARED_BYTES]}")
    fn = lib.pqmf_synthesis
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(adjoint: int, x: torch.Tensor, table: torch.Tensor, shift: int) -> torch.Tensor:
    b, frames, m = x.shape
    check_synthesis_kernel(m, table.shape[0], x.dtype)
    if table.dtype is not torch.float32 or table.device != x.device or table.shape != (table.shape[0], m, m):
        raise ValueError(f"the tap table must be fp32 [I, {m}, {m}] on {x.device}, not {table.dtype} "
                         f"{tuple(table.shape)} on {table.device}")
    x, table = x.contiguous(), table.contiguous()
    out = torch.empty_like(x)
    fn = _kernel()
    launch_checked(lambda stream: fn(adjoint, x.data_ptr(), table.data_ptr(), out.data_ptr(), b, frames, m,
                                     table.shape[0], shift, _DTYPE_CODES[x.dtype], stream),
                   x.device, "pqmf_synthesis")
    return out


def _run(adjoint: int, x: torch.Tensor, table: torch.Tensor, shift: int) -> torch.Tensor:
    if x.dim() != 3:
        raise ValueError(f"the PQMF synthesis takes frames [B, L, M], not {tuple(x.shape)}")
    if x.device.type == "cpu":
        return (synthesis_adjoint_plain if adjoint else synthesis_plain)(x, table, shift)
    if x.device.type != "cuda":
        raise ValueError(f"the PQMF synthesis runs on cpu or cuda tensors, not {x.device}")
    return _launch(adjoint, x, table, shift)


def synthesis(frames: torch.Tensor, table: torch.Tensor, shift: int) -> torch.Tensor:
    """frames [B, L, M] -> the kept synthesis [B, L, M] through ``table``
    (``synthesis_table``) and ``shift`` (``synthesis_offsets``). CPU tensors
    take ``synthesis_plain``; CUDA tensors launch the kernel (``launches``
    counts them) or raise; any other device raises."""
    out = _run(0, frames, table, shift)
    synthesis.launches += frames.device.type == "cuda"
    return out


def synthesis_adjoint(grad: torch.Tensor, table: torch.Tensor, shift: int) -> torch.Tensor:
    """The adjoint of ``synthesis``: the output's gradient [B, L, M] -> the
    frames' [B, L, M]. CPU tensors take ``synthesis_adjoint_plain``; CUDA
    tensors launch the adjoint kernel (``launches``) or raise."""
    out = _run(1, grad, table, shift)
    synthesis_adjoint.launches += grad.device.type == "cuda"
    return out


synthesis.launches = 0
synthesis_adjoint.launches = 0


class PQMFSynthesis(torch.autograd.Function):
    """``synthesis`` forward, ``synthesis_adjoint`` backward (in the span
    ``taa.pqmf.synthesis_bwd``); the table and the shift take no gradient.
    The frames' gradient comes back [B, L, M] contiguous. Under
    ``torch.func.vmap`` the vmapped axis folds into the batch axis: one
    launch each way for all K."""

    @staticmethod
    def forward(frames, table, shift):
        return synthesis(frames, table, shift)

    @staticmethod
    def setup_context(ctx, inputs, output):
        _, table, shift = inputs
        ctx.save_for_backward(table)
        ctx.shift = shift

    @staticmethod
    def vmap(info, in_dims, frames, table, shift):
        if in_dims[1] is not None:
            raise ValueError("PQMFSynthesis takes one tap table for every vmapped element")
        (x,) = fold_vmapped(info, in_dims[:1], frames)
        y = PQMFSynthesis.apply(x, table, shift)
        return y.reshape(info.batch_size, -1, *y.shape[1:]), 0

    @staticmethod
    def backward(ctx, grad):
        with span("taa.pqmf.synthesis_bwd", device=True):
            (table,) = ctx.saved_tensors
            return synthesis_adjoint(grad, table, ctx.shift), None, None


@lru_cache(maxsize=8)
def _design_cached(attenuation: float, n_band: int):
    """The cutoff search costs host time per (attenuation, M): cache it
    per process so repeated model creation is free."""
    with setup_span("taa.setup.pqmf_design"):
        return design_prototype(attenuation, n_band)


class PQMF(nn.Module):
    """Near-perfect-reconstruction pseudo-QMF filterbank.

    forward: [B, 1, T] -> [B, M, T/M]   (T must be divisible by M)
    inverse: [B, M, T/M] -> [B, 1, T]

    The [M, 1, N] filters are a non-persistent buffer: they follow the
    module's device but are not parameters and not in its state_dict. The
    synthesis kernels' tap tables are built from them once per (input
    type, device, filters' type) and kept in ``_tables``.
    """

    def __init__(self, attenuation: float = 100.0, n_band: int = 16):
        super().__init__()
        h, err = _design_cached(float(attenuation), int(n_band))
        hk = _modulate(h, n_band).astype(np.float32)
        self.attenuation = attenuation
        self.n_band = n_band
        self.recon_error = err
        self.register_buffer("filters", torch.from_numpy(hk)[:, None, :], persistent=False)
        self._tables = {}

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
        with span("taa.pqmf.analysis"):
            w = self.filters.to(x.dtype)
            return F.conv1d(F.pad(x, (pad, pad - (m - 1))), w, stride=m)

    def kernel_table(self, dtype: torch.dtype, device) -> torch.Tensor:
        """``synthesis_table`` of the filters for inputs of ``dtype`` on
        ``device``, built and copied there once. Built outside
        ``torch.inference_mode`` (the codec's), so that a training step may
        save it for its backward."""
        key = (dtype, torch.device(device), self.filters.dtype)
        table = self._tables.get(key)
        if table is None:
            with torch.inference_mode(False), torch.no_grad():
                table = self._tables[key] = synthesis_table(self.filters, dtype).to(device)
        return table

    def inverse(self, z: torch.Tensor) -> torch.Tensor:
        """Synthesis: M * adjoint(analysis). z: [B, M, T/M] -> [B, 1, T].
        CPU tensors take the transposed conv; others the kernels, through
        ``PQMFSynthesis`` on z's frames [B, T/M, M] (a view where z is the
        transpose of a contiguous [B, T/M, M], as ``decode`` passes it)."""
        m, n = self.n_band, self.taps
        t = z.shape[-1] * m
        with span("taa.pqmf.synthesis", device=True):
            if z.device.type == "cpu":
                pad = n // 2
                y = F.conv_transpose1d(z, self.filters.to(z.dtype), stride=m)
                return y[..., pad : pad + t] * float(m)
            frames = z.transpose(-1, -2).reshape(-1, z.shape[-1], m)
            y = PQMFSynthesis.apply(frames, self.kernel_table(z.dtype, z.device), synthesis_offsets(m, n)[1])
            count("pqmf.synthesis_kernel")
            return y.reshape(*z.shape[:-2], 1, t)
