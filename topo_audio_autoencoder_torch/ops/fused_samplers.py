"""The binary Gumbel relaxation as one fused pass: the plain torch version
and the wrapper of the hand-written CUDA kernel ``csrc/binary_gumbel.cu``.

Port of the binary-Gumbel part of ``topo_audio_autoencoder_tpu.ops.pallas_kernels``
(``binary_gumbel_fused`` and the differentiable ``binary_gumbel_fused_diff``).
The kernel draws its uniforms with Philox4x32-10 keyed by (seed, offset);
``philox_uniform`` computes the same stream in plain torch, bit for bit, so
the CPU and the card sample the same noise from the same seed. Either side
can instead take the uniforms as a tensor (``noise=``), which is how the
tests hand both packages the same numbers. ``first`` starts a draw at
element ``first`` of the stream: a data-parallel rank draws its rows of
the global batch's draw with ``first`` = its first row times the row
length, and ``first=0`` is the whole batch's draw.

``binary_gumbel_sample`` takes the plain version for CPU tensors and
launches the kernel for CUDA tensors (``launches`` counts those launches);
it never falls back from one to the other. The closed-form backward
(``binary_gumbel_bwd``, the JAX package's ``_bg_bwd``) does the same with
its own kernel in the same source.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .samplers import UNIFORM_MAX, UNIFORM_MIN, binary_gumbel

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b for a 32-bit constant ``a`` and int64
    tensors holding 32-bit words, without overflowing int64."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    low = a_lo * b  # < 2^48
    t = a_hi * b + (low >> 16)  # < 2^49
    hi = t >> 16
    lo = ((t & 0xFFFF) << 16) | (low & 0xFFFF)
    return hi, lo


def philox_uniform(numel: int, seed: int, offset: int = 0, device=None, first: int = 0) -> torch.Tensor:
    """The kernel's uniforms for elements first .. first+numel-1, in plain
    torch.

    Philox4x32-10 with key = the 64-bit seed and counter = (g, offset) for
    the group g of elements 4g .. 4g+3; word j of a block becomes
    ``(word >> 8) * 2^-24`` clipped to [1e-6, 1 - 1e-6]. Element e is word
    e & 3 of group e >> 2. Returns fp32 [numel].
    """
    g = torch.arange(first >> 2, (first + numel + 3) >> 2, dtype=torch.int64, device=device)
    c = [g & _MASK32, g >> 32,
         torch.full_like(g, offset & _MASK32), torch.full_like(g, (offset >> 32) & _MASK32)]
    k0, k1 = seed & _MASK32, (seed >> 32) & _MASK32
    for round_ in range(10):
        if round_:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    lead = first & 3
    bits = torch.stack(c, dim=-1).reshape(-1)[lead : lead + numel]
    u = (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return torch.clamp(u, UNIFORM_MIN, UNIFORM_MAX)


def binary_gumbel_plain(logits: torch.Tensor, u: torch.Tensor, temperature: float) -> torch.Tensor:
    """The kernel's function in plain torch: fp32 inside, output in the
    logits' dtype. ``u``: uniforms of the logits' shape."""
    lf = logits.to(torch.float32)
    n = torch.log(u) - torch.log1p(-u)
    return torch.sigmoid((2.0 * lf - 1.0 + n) / float(temperature)).to(logits.dtype)


@lru_cache(maxsize=None)
def _kernels():
    """The C entry points of csrc/binary_gumbel.cu, built on first use."""
    from ..cuda_build import load

    lib = load("binary_gumbel")
    philox = lib.binary_gumbel_philox
    philox.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_uint64, ctypes.c_uint64,
                                               ctypes.c_uint64, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    philox.restype = ctypes.c_int
    noise = lib.binary_gumbel_noise
    noise.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                                              ctypes.c_void_p]
    noise.restype = ctypes.c_int
    bwd = lib.binary_gumbel_bwd
    bwd.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    return philox, noise, bwd


def _check_inputs(x: torch.Tensor, seed: int, offset: int, noise: torch.Tensor | None, what: str,
                  first: int = 0):
    """Validates a sampler's input ``x`` for its device and the draw's
    (seed, offset, first) or uniforms; returns the uniforms, if given, as
    fp32 on ``x``'s device."""
    if not 0 <= seed < 2**64 or not 0 <= offset < 2**64:
        raise ValueError("seed and offset are unsigned 64-bit integers")
    if not 0 <= first <= 2**64 - 1 - x.numel():
        raise ValueError(f"first={first}: the draw's elements must have unsigned 64-bit indices")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {x.device}")
    if x.device.type == "cuda":
        if x.dtype not in _DTYPE_CODES:
            raise TypeError(f"the {what} kernel takes float32 or bfloat16 input, not {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"the {what} kernel takes a contiguous input")
    if noise is not None:
        if noise.shape != x.shape:
            raise ValueError(f"noise {tuple(noise.shape)} must match the input {tuple(x.shape)}")
        noise = noise.to(device=x.device, dtype=torch.float32).contiguous()
    return noise


def launch_checked(launch, device: torch.device, what: str) -> None:
    """Runs ``launch(stream) -> CUDA error code`` on ``device``'s current
    stream and raises if the launch failed."""
    with torch.cuda.device(device):
        err = launch(torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def _run(x, seed, offset, noise, return_noise, plain, launch, what, first=0):
    """One sampler pass over ``x``: ``plain(u)`` for a CPU tensor, on the
    uniforms ``noise`` or the Philox stream of (seed, offset) from element
    ``first``; for a CUDA
    tensor the kernel, through ``launch(out, noise, u_out, stream) -> CUDA
    error code`` (``u_out``, when not None, receives the kernel's
    uniforms). Returns the output, and the uniforms with ``return_noise``."""
    if x.device.type == "cpu":
        u = noise if noise is not None else philox_uniform(x.numel(), seed, offset, x.device, first).reshape(x.shape)
        out = plain(u)
        return (out, u) if return_noise else out
    u_out = None
    if return_noise and noise is None:
        u_out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    launch_checked(lambda stream: launch(out, noise, u_out, stream), x.device, what)
    if return_noise:
        return out, (noise if noise is not None else u_out)
    return out


def binary_gumbel_sample(
    logits: torch.Tensor,
    temperature: float,
    seed: int = 0,
    offset: int = 0,
    noise: torch.Tensor | None = None,
    return_noise: bool = False,
    first: int = 0,
):
    """``s = sigmoid((2l - 1 + logistic(u)) / T)`` in one pass.

    ``u`` is ``noise`` (fp32 uniforms of the logits' shape) when given,
    else the Philox stream of (``seed``, ``offset``) from element
    ``first``. With ``return_noise``
    the uniforms used are returned too: ``(s, u)``. CPU tensors take the
    plain version; CUDA tensors launch the kernel; any other device raises.
    """
    temperature = float(temperature)
    if not temperature > 0.0:
        raise ValueError(f"temperature must be positive, not {temperature}")
    noise = _check_inputs(logits, seed, offset, noise, "binary_gumbel_sample", first)

    def launch(out, noise, u_out, stream):
        philox, from_noise, _ = _kernels()
        code = _DTYPE_CODES[logits.dtype]
        if noise is not None:
            err = from_noise(logits.data_ptr(), noise.data_ptr(), out.data_ptr(),
                             logits.numel(), temperature, code, stream)
        else:
            err = philox(logits.data_ptr(), out.data_ptr(), 0 if u_out is None else u_out.data_ptr(),
                         logits.numel(), seed, offset, first, temperature, code, stream)
        if err == 0:
            binary_gumbel_sample.launches += 1
        return err

    return _run(logits, seed, offset, noise, return_noise,
                lambda u: binary_gumbel_plain(logits, u, temperature), launch, "binary_gumbel", first)


binary_gumbel_sample.launches = 0


def binary_gumbel_bwd_plain(s: torch.Tensor, ct: torch.Tensor, temperature: float) -> torch.Tensor:
    """The backward kernel's function in plain torch: ``dl = ct * 2 s (1 -
    s) / T``, fp32 inside, in ``s``'s dtype."""
    sf = s.to(torch.float32)
    ds = 2.0 * sf * (1.0 - sf) / float(temperature)
    return (ct.to(torch.float32) * ds).to(s.dtype)


def check_cotangent(x: torch.Tensor, ct: torch.Tensor, what: str) -> torch.Tensor:
    """Validates a sampler backward's residual ``x`` and cotangent ``ct``
    for the device of ``x``; returns ``ct`` contiguous for a CUDA kernel."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cpu or cuda tensors, not {x.device}")
    if ct.shape != x.shape or ct.device != x.device:
        raise ValueError(f"{what}: the cotangent {tuple(ct.shape)} on {ct.device} must match "
                         f"{tuple(x.shape)} on {x.device}")
    if x.device.type == "cuda":
        if x.dtype not in _DTYPE_CODES or ct.dtype not in _DTYPE_CODES:
            raise TypeError(f"the {what} kernel takes float32 or bfloat16, not {x.dtype} and {ct.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"the {what} kernel takes a contiguous residual")
        ct = ct.contiguous()
    return ct


def binary_gumbel_bwd(s: torch.Tensor, ct: torch.Tensor, temperature: float) -> torch.Tensor:
    """The relaxation's gradient to the logits from its output ``s``:
    ``ct * 2 s (1 - s) / T`` in ``s``'s dtype (the cotangent in either
    dtype). CPU tensors take the plain version; CUDA tensors launch the
    kernel (counted in ``launches``); any other device raises."""
    temperature = float(temperature)
    if not temperature > 0.0:
        raise ValueError(f"temperature must be positive, not {temperature}")
    ct = check_cotangent(s, ct, "binary_gumbel_bwd")
    if s.device.type == "cpu":
        return binary_gumbel_bwd_plain(s, ct, temperature)
    _, _, bwd = _kernels()
    dl = torch.empty_like(s)
    launch_checked(lambda stream: bwd(s.data_ptr(), ct.data_ptr(), dl.data_ptr(), s.numel(), temperature,
                                      _DTYPE_CODES[s.dtype], _DTYPE_CODES[ct.dtype], stream),
                   s.device, "binary_gumbel_bwd")
    binary_gumbel_bwd.launches += 1
    return dl


binary_gumbel_bwd.launches = 0


def seed_from(generator: torch.Generator) -> int:
    """A 63-bit Philox seed drawn from ``generator`` (on its own device; a
    CPU generator costs the card no synchronisation)."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator,
                             device=generator.device).item())


def _seed(generator: torch.Generator | None, noise: torch.Tensor | None) -> int:
    """The Philox seed of a train-mode draw: unused (0) when the uniforms
    are given, else drawn from ``generator``."""
    if noise is not None:
        return 0
    if generator is None:
        raise ValueError("a train-mode fused sample needs a generator or noise")
    return seed_from(generator)


def binary_gumbel_fused(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    temperature,
    training: bool = True,
    noise: torch.Tensor | None = None,
    first: int = 0,
) -> torch.Tensor:
    """Binary Gumbel sample through the fused pass; eval mode thresholds
    at 0.5 like ``samplers.binary_gumbel``. The seed comes from
    ``generator`` unless ``noise`` is given; the draw starts at element
    ``first`` of its stream."""
    if not training:
        return binary_gumbel(logits, None, temperature, training=False)
    return binary_gumbel_sample(logits, float(temperature), seed=_seed(generator, noise), noise=noise,
                                first=first)


class BinaryGumbel(torch.autograd.Function):
    """Fused forward; backward in closed form from the output alone,
    ds/dl = 2 s (1 - s) / T, in one pass (``binary_gumbel_bwd``). The
    temperature takes no gradient."""

    @staticmethod
    def forward(ctx, logits, temperature, seed, noise, first):
        s = binary_gumbel_sample(logits, temperature, seed=seed, noise=noise, first=first)
        ctx.save_for_backward(s)
        ctx.temperature = float(temperature)
        return s

    @staticmethod
    def backward(ctx, ct):
        (s,) = ctx.saved_tensors
        return binary_gumbel_bwd(s, ct, ctx.temperature), None, None, None, None


def binary_gumbel_fused_diff(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    temperature,
    training: bool = True,
    noise: torch.Tensor | None = None,
    first: int = 0,
) -> torch.Tensor:
    """``binary_gumbel_fused`` with the closed-form gradient to the logits
    (eval mode: a threshold, with no gradient)."""
    if not training:
        return binary_gumbel(logits, None, temperature, training=False)
    return BinaryGumbel.apply(logits, float(temperature), _seed(generator, noise), noise, first)
