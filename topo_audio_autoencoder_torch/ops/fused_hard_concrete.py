"""The Hard Concrete gate as one fused pass, with a fixed or a learned
stretch: the plain torch versions and the wrappers of the hand-written CUDA
kernels in ``csrc/hard_concrete.cu``.

Port of the Hard Concrete part of ``topo_audio_autoencoder_tpu.ops.pallas_kernels``
(``hard_concrete_fused``, ``hard_concrete_fused_learned`` and their
differentiable ``*_diff`` forms). The kernels draw the Philox stream of
``fused_samplers.philox_uniform``, which the plain versions use on the CPU,
so the CPU and the card sample the same gates from the same seed, from
element ``first`` of the stream (a data-parallel rank's rows of the global
draw); either side can instead take the uniforms as a tensor (``noise=``).

``hard_concrete_sample`` and ``hard_concrete_learned_sample`` take the
plain version for CPU tensors and launch a kernel for CUDA tensors (each
counts its launches in ``launches``); they never fall back from one to the
other. The gradients are closed-form in the output ``z`` (the JAX
package's ``_hc_bwd`` and ``_hcl_bwd``): ``hard_concrete_bwd`` and
``hard_concrete_learned_bwd`` dispatch the same way, to the backward
kernel in the same source (one template over the stretch, like the
forward's), whose column sums over the batch run in a fixed order
(``column_sums``).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from .fused_samplers import _DTYPE_CODES, _check_inputs, _run, _seed, check_cotangent, launch_checked
from .samplers import HardConcreteParams, hard_concrete

GAMMA = HardConcreteParams.gamma
ZETA = HardConcreteParams.zeta


def hard_concrete_plain(
    log_alpha: torch.Tensor, u: torch.Tensor, temperature: float, gamma: float = GAMMA, zeta: float = ZETA
) -> torch.Tensor:
    """The fixed-stretch kernel's function in plain torch: fp32 inside,
    output in log-alpha's dtype. ``u``: uniforms of log-alpha's shape."""
    a = log_alpha.to(torch.float32)
    t, g, z = (torch.as_tensor(v, device=a.device).to(torch.float32) for v in (temperature, gamma, zeta))
    n = torch.log(u) - torch.log1p(-u)
    s = torch.sigmoid((n + a) / t)
    return torch.clamp(s * (z - g) + g, 0.0, 1.0).to(log_alpha.dtype)


def hard_concrete_learned_plain(
    log_alpha: torch.Tensor, u: torch.Tensor, beta: torch.Tensor, gamma: torch.Tensor, zeta: torch.Tensor
) -> torch.Tensor:
    """The learned-stretch kernel's function in plain torch: ``beta``,
    ``gamma`` and ``zeta`` are [S] rows over log-alpha's last axis, read as
    fp32."""
    return hard_concrete_plain(log_alpha, u, beta, gamma, zeta)


@lru_cache(maxsize=None)
def _kernels():
    """The C entry points of csrc/hard_concrete.cu, built on first use."""
    from ..cuda_build import load

    lib = load("hard_concrete")
    ptr, i64, u64, f32, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_float, ctypes.c_int
    signatures = {
        "hard_concrete_philox": [ptr] * 3 + [i64, u64, u64, u64, f32, f32, f32, i32, ptr],
        "hard_concrete_noise": [ptr] * 3 + [i64, f32, f32, f32, i32, ptr],
        "hard_concrete_learned_philox": [ptr] * 6 + [i64, i64, u64, u64, u64, i32, ptr],
        "hard_concrete_learned_noise": [ptr] * 6 + [i64, i64, i32, ptr],
        "hard_concrete_bwd": [ptr] * 3 + [i64, f32, f32, f32, i32, i32, i32, ptr],
        "hard_concrete_learned_bwd": [ptr] * 9 + [i64, i64, i32, i32, i32, ptr],
    }
    fns = {}
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def hard_concrete_sample(
    log_alpha: torch.Tensor,
    temperature: float,
    seed: int = 0,
    offset: int = 0,
    noise: torch.Tensor | None = None,
    return_noise: bool = False,
    gamma: float = GAMMA,
    zeta: float = ZETA,
    first: int = 0,
):
    """``z = clip(sigmoid((logistic(u) + a) / T) (zeta - gamma) + gamma, 0, 1)``
    in one pass, with a fixed stretch.

    ``u`` is ``noise`` (fp32 uniforms of log-alpha's shape) when given,
    else the Philox stream of (``seed``, ``offset``) from element
    ``first``. With ``return_noise``
    the uniforms used are returned too: ``(z, u)``. CPU tensors take the
    plain version; CUDA tensors launch the kernel; any other device raises.
    """
    temperature, gamma, zeta = float(temperature), float(gamma), float(zeta)
    if not temperature > 0.0:
        raise ValueError(f"temperature must be positive, not {temperature}")
    noise = _check_inputs(log_alpha, seed, offset, noise, "hard_concrete_sample", first)

    def launch(out, noise, u_out, stream):
        fns = _kernels()
        code = _DTYPE_CODES[log_alpha.dtype]
        if noise is not None:
            err = fns["hard_concrete_noise"](log_alpha.data_ptr(), noise.data_ptr(), out.data_ptr(),
                                             log_alpha.numel(), temperature, gamma, zeta, code, stream)
        else:
            err = fns["hard_concrete_philox"](
                log_alpha.data_ptr(), out.data_ptr(), 0 if u_out is None else u_out.data_ptr(),
                log_alpha.numel(), seed, offset, first, temperature, gamma, zeta, code, stream)
        if err == 0:
            hard_concrete_sample.launches += 1
        return err

    return _run(log_alpha, seed, offset, noise, return_noise,
                lambda u: hard_concrete_plain(log_alpha, u, temperature, gamma, zeta), launch, "hard_concrete",
                first)


hard_concrete_sample.launches = 0


def hard_concrete_learned_sample(
    log_alpha: torch.Tensor,
    beta: torch.Tensor,
    gamma: torch.Tensor,
    zeta: torch.Tensor,
    seed: int = 0,
    offset: int = 0,
    noise: torch.Tensor | None = None,
    return_noise: bool = False,
    first: int = 0,
):
    """The Hard Concrete gate with a learned per-simplex stretch: ``beta``
    (in place of the temperature), ``gamma`` and ``zeta`` are [S] rows over
    log-alpha's last axis, read as fp32 (round them to the compute dtype
    first, as the encoder does). Otherwise as ``hard_concrete_sample``."""
    cols = log_alpha.shape[-1]
    for name, row in (("beta", beta), ("gamma", gamma), ("zeta", zeta)):
        if tuple(row.shape) != (cols,):
            raise ValueError(f"{name} {tuple(row.shape)} must be a row of log_alpha's last axis ({cols},)")
    noise = _check_inputs(log_alpha, seed, offset, noise, "hard_concrete_learned_sample", first)
    rows = [r.detach().to(device=log_alpha.device, dtype=torch.float32).contiguous() for r in (beta, gamma, zeta)]

    def launch(out, noise, u_out, stream):
        fns = _kernels()
        code = _DTYPE_CODES[log_alpha.dtype]
        ptrs = [r.data_ptr() for r in rows]
        if noise is not None:
            err = fns["hard_concrete_learned_noise"](
                log_alpha.data_ptr(), noise.data_ptr(), *ptrs, out.data_ptr(),
                log_alpha.numel(), cols, code, stream)
        else:
            err = fns["hard_concrete_learned_philox"](
                log_alpha.data_ptr(), *ptrs, out.data_ptr(), 0 if u_out is None else u_out.data_ptr(),
                log_alpha.numel(), cols, seed, offset, first, code, stream)
        if err == 0:
            hard_concrete_learned_sample.launches += 1
        return err

    return _run(log_alpha, seed, offset, noise, return_noise,
                lambda u: hard_concrete_learned_plain(log_alpha, u, *rows), launch, "hard_concrete_learned", first)


hard_concrete_learned_sample.launches = 0


def _recovered_s(z, gamma, zeta):
    """The pre-clip sigmoid recovered from the gate where it is unclipped
    (clipped gates take no gradient, so any in-range value serves there),
    and the mask of unclipped gates."""
    s = torch.clamp((z - gamma) / (zeta - gamma), 1e-6, 1.0 - 1e-6)
    return s, ((z > 0.0) & (z < 1.0)).to(z.dtype)


# The most row slices the backward kernel splits a column's rows into.
MAX_SLICES = 16


def row_slices(rows: int) -> list:
    """The backward kernel's row slices of a column, in its merge order:
    P (the largest power of two <= min(MAX_SLICES, rows)) contiguous ranges
    of ceil(rows / P) rows, the last ones short or empty."""
    p = 1
    while p < MAX_SLICES and 2 * p <= rows:
        p *= 2
    chunk = -(-rows // p)
    return [(min(k * chunk, rows), min((k + 1) * chunk, rows)) for k in range(p)]


def column_sums(t: torch.Tensor) -> torch.Tensor:
    """Sums of ``t`` over every axis but the last, in the backward kernel's
    order: each row slice adds its rows in order from zero, then the
    partials are added in slice order from zero. fp32 in, [cols] out."""
    rows = t.reshape(-1, t.shape[-1])
    total = torch.zeros_like(rows[0])
    for r0, r1 in row_slices(rows.shape[0]):
        part = torch.zeros_like(rows[0])
        for r in range(r0, r1):
            part = part + rows[r]
        total = total + part
    return total


def hard_concrete_bwd_plain(z: torch.Tensor, ct: torch.Tensor, temperature: float, training: bool) -> torch.Tensor:
    """The fixed-stretch backward kernel's function in plain torch:
    ``da = ct * (1{0<z<1} s (1 - s) (zeta - gamma) / T)`` (eval: no ``/ T``),
    fp32 inside, in ``z``'s dtype."""
    scale = (ZETA - GAMMA) / temperature if training else ZETA - GAMMA
    s, inside = _recovered_s(z.to(torch.float32), GAMMA, ZETA)
    dz = inside * s * (1.0 - s) * scale
    return (ct.to(torch.float32) * dz).to(z.dtype)


def hard_concrete_learned_terms(z, ct, beta, gamma, zeta, training: bool) -> tuple:
    """The learned-stretch backward per element, fp32: with ``s`` recovered
    from ``z`` and ``sp = 1{0<z<1} s (1 - s)``::

        da = ct sp (zeta - gamma) / beta        (eval: no / beta)
        tb = ct sp (zeta - gamma) (-logit s) / beta   (eval: None)
        tg = ct 1{0<z<1} (1 - s),   tz = ct 1{0<z<1} s

    ``tb``, ``tg`` and ``tz`` summed over every axis but the last are the
    stretch rows' cotangents."""
    f32 = torch.float32
    zf, bf, gf, zetaf, ctf = (t.to(f32) for t in (z, beta, gamma, zeta, ct))
    span = zetaf - gf
    s, inside = _recovered_s(zf, gf, zetaf)
    sp = inside * s * (1.0 - s)
    if training:
        logit_s = torch.log(s) - torch.log1p(-s)
        da = ctf * sp * span / bf
        tb = ctf * sp * span * (-logit_s) / bf
    else:
        da, tb = ctf * sp * span, None
    return da, tb, ctf * inside * (1.0 - s), ctf * inside * s


def hard_concrete_learned_bwd_plain(z, ct, beta, gamma, zeta, training: bool) -> tuple:
    """The learned-stretch backward kernel's function in plain torch:
    ``hard_concrete_learned_terms`` with the stretch terms summed by
    ``column_sums`` (the kernel's order; dbeta is 0 in eval). Returns (da,
    dbeta, dgamma, dzeta) in the dtypes of ``z`` and the three rows."""
    da, tb, tg, tz = hard_concrete_learned_terms(z, ct, beta, gamma, zeta, training)
    dbeta = column_sums(tb) if training else torch.zeros(beta.shape, dtype=torch.float32, device=z.device)
    return (da.to(z.dtype), dbeta.to(beta.dtype), column_sums(tg).to(gamma.dtype),
            column_sums(tz).to(zeta.dtype))


def hard_concrete_bwd(z: torch.Tensor, ct: torch.Tensor, temperature: float, training: bool) -> torch.Tensor:
    """The fixed-stretch gate's gradient to log-alpha from the gate ``z``,
    in ``z``'s dtype. CPU tensors take the plain version; CUDA tensors
    launch the kernel (counted in ``launches``); any other device raises."""
    temperature = float(temperature)
    if not temperature > 0.0:
        raise ValueError(f"temperature must be positive, not {temperature}")
    ct = check_cotangent(z, ct, "hard_concrete_bwd")
    if z.device.type == "cpu":
        return hard_concrete_bwd_plain(z, ct, temperature, training)
    scale = (ZETA - GAMMA) / temperature if training else ZETA - GAMMA
    da = torch.empty_like(z)
    launch_checked(lambda stream: _kernels()["hard_concrete_bwd"](
        z.data_ptr(), ct.data_ptr(), da.data_ptr(), z.numel(), GAMMA, ZETA, scale, int(training),
        _DTYPE_CODES[z.dtype], _DTYPE_CODES[ct.dtype], stream), z.device, "hard_concrete_bwd")
    hard_concrete_bwd.launches += 1
    return da


hard_concrete_bwd.launches = 0


def hard_concrete_learned_bwd(z, ct, beta, gamma, zeta, training: bool) -> tuple:
    """The learned-stretch gate's gradients from the gate ``z``: (da,
    dbeta, dgamma, dzeta), the stretch rows' summed over every axis of
    ``z`` but the last, each in its leaf's dtype. The rows are read as
    fp32 (rounded to the compute dtype first, as in the forward). CPU
    tensors take the plain version; CUDA tensors launch the kernel (counted
    in ``launches``); any other device raises."""
    cols = z.shape[-1]
    for name, row in (("beta", beta), ("gamma", gamma), ("zeta", zeta)):
        if tuple(row.shape) != (cols,):
            raise ValueError(f"{name} {tuple(row.shape)} must be a row of z's last axis ({cols},)")
    ct = check_cotangent(z, ct, "hard_concrete_learned_bwd")
    if z.device.type == "cpu":
        return hard_concrete_learned_bwd_plain(z, ct, beta, gamma, zeta, training)
    rows = [r.detach().to(device=z.device, dtype=torch.float32).contiguous() for r in (beta, gamma, zeta)]
    da = torch.empty_like(z)
    sums = [torch.empty(cols, dtype=torch.float32, device=z.device) for _ in range(3)]
    launch_checked(lambda stream: _kernels()["hard_concrete_learned_bwd"](
        z.data_ptr(), ct.data_ptr(), *(r.data_ptr() for r in rows), da.data_ptr(), *(t.data_ptr() for t in sums),
        z.numel(), cols, int(training), _DTYPE_CODES[z.dtype], _DTYPE_CODES[ct.dtype], stream),
        z.device, "hard_concrete_learned_bwd")
    hard_concrete_learned_bwd.launches += 1
    return (da, *(t.to(r.dtype) for t, r in zip(sums, (beta, gamma, zeta))))


hard_concrete_learned_bwd.launches = 0


class HardConcrete(torch.autograd.Function):
    """Fixed stretch: the fused sample (train) or the noiseless gate (eval);
    backward ``dz/da = 1{0<z<1} s (1 - s) (zeta - gamma) / T`` (eval: no
    ``/ T``) in one pass (``hard_concrete_bwd``). The temperature takes no
    gradient."""

    @staticmethod
    def forward(ctx, log_alpha, temperature, training, seed, noise, first):
        if training:
            z = hard_concrete_sample(log_alpha, temperature, seed=seed, noise=noise, first=first)
        else:
            z = hard_concrete(log_alpha, None, temperature, training=False)
        ctx.save_for_backward(z)
        ctx.temperature, ctx.training = float(temperature), training
        return z

    @staticmethod
    def backward(ctx, ct):
        (z,) = ctx.saved_tensors
        return hard_concrete_bwd(z, ct, ctx.temperature, ctx.training), None, None, None, None, None


class HardConcreteLearned(torch.autograd.Function):
    """Learned stretch: the fused sample (train) or the noiseless gate
    (eval); backward in one pass (``hard_concrete_learned_bwd``): on
    unclipped gates, with ``s = sigmoid(a / beta)`` and ``z = clip(s (zeta -
    gamma) + gamma, 0, 1)``::

        dz/da = s (1 - s) (zeta - gamma) / beta     (eval: no / beta)
        dz/dbeta = -s (1 - s) (zeta - gamma) logit(s) / beta   (eval: 0)
        dz/dgamma = 1 - s,   dz/dzeta = s

    the stretch cotangents summed over the batch axes to [S]."""

    @staticmethod
    def forward(ctx, log_alpha, beta, gamma, zeta, training, seed, noise, first):
        if training:
            z = hard_concrete_learned_sample(log_alpha, beta, gamma, zeta, seed=seed, noise=noise, first=first)
        else:
            z = hard_concrete(log_alpha, None, beta, HardConcreteParams(gamma, zeta), training=False)
        ctx.save_for_backward(z, beta, gamma, zeta)
        ctx.training = training
        return z

    @staticmethod
    def backward(ctx, ct):
        z, beta, gamma, zeta = ctx.saved_tensors
        return (*hard_concrete_learned_bwd(z, ct, beta, gamma, zeta, ctx.training), None, None, None, None)


def hard_concrete_fused_diff(
    log_alpha: torch.Tensor,
    generator: torch.Generator | None,
    temperature,
    training: bool = True,
    noise: torch.Tensor | None = None,
    first: int = 0,
) -> torch.Tensor:
    """Fixed-stretch Hard Concrete through the fused pass, with the
    closed-form gradient to log-alpha. The seed comes from ``generator``
    unless ``noise`` is given, and the draw starts at element ``first`` of
    its stream; eval mode is the noiseless gate."""
    seed = _seed(generator, noise) if training else 0
    return HardConcrete.apply(log_alpha, float(temperature), training, seed, noise, first)


def hard_concrete_fused_learned_diff(
    log_alpha: torch.Tensor,
    generator: torch.Generator | None,
    beta: torch.Tensor,
    gamma: torch.Tensor,
    zeta: torch.Tensor,
    training: bool = True,
    noise: torch.Tensor | None = None,
    first: int = 0,
) -> torch.Tensor:
    """Learned-stretch Hard Concrete through the fused pass, with the
    closed-form gradients to log-alpha and to the [S] stretch rows (the
    draw from element ``first``, as ``hard_concrete_fused_diff``)."""
    seed = _seed(generator, noise) if training else 0
    return HardConcreteLearned.apply(log_alpha, beta, gamma, zeta, training, seed, noise, first)
