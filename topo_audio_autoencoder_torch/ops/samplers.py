"""Stochastic binarization: the binary Gumbel relaxation, its temperature
schedule and the straight-through estimator.

Port of the binary-Gumbel part of ``topo_audio_autoencoder_tpu.ops.samplers``
(Hard Concrete comes with a later slice). These are the plain samplers,
drawing their noise with ``torch.rand`` from an explicit generator; the
encoder's default path is the fused kernel in ``ops.fused_samplers``.
"""

from __future__ import annotations

import torch

UNIFORM_MIN = 1e-6
UNIFORM_MAX = 1.0 - 1e-6


def temperature_schedule(
    epoch, initial_temp: float = 5.0, min_temp: float = 0.1, decay: float = 0.95
) -> torch.Tensor:
    """Per-epoch annealing max(min_temp, T0 * decay^epoch), in fp32 (a 0-d
    tensor on the CPU)."""
    e = torch.as_tensor(epoch, dtype=torch.float32)
    return torch.clamp(initial_temp * torch.pow(torch.tensor(decay), e), min=min_temp)


def straight_through(hard: torch.Tensor, soft: torch.Tensor) -> torch.Tensor:
    """Forward value = hard, gradient = d(soft): y = soft + sg(hard - soft)."""
    return soft + (hard - soft).detach()


def uniform_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """fp32 uniforms on [1e-6, 1 - 1e-6] from ``generator``, on ``device``
    (drawn on the generator's own device, then moved)."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return (u * (UNIFORM_MAX - UNIFORM_MIN) + UNIFORM_MIN).to(device)


def logistic_noise(u: torch.Tensor) -> torch.Tensor:
    """A standard logistic sample from uniforms: log u - log(1 - u)."""
    return torch.log(u) - torch.log1p(-u)


def binary_gumbel(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    temperature,
    training: bool = True,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """Binary Gumbel-softmax relaxation.

    Train mode: ``sigmoid((2l - 1 + logistic(u)) / T)`` with ``u`` uniform
    on [1e-6, 1 - 1e-6], drawn from ``generator`` or given as ``noise`` (a
    tensor of uniforms of the logits' shape). It computes in the logits'
    dtype: the temperature is cast to it, so an fp32 temperature never
    promotes a bf16 relaxation (and everything after it) to fp32.
    Eval mode thresholds the noiseless relaxation at 0.5, which reduces to
    ``logits > 0.5``.
    """
    if not training:
        return (logits > 0.5).to(logits.dtype)
    if noise is None:
        if generator is None:
            raise ValueError("binary_gumbel(training=True) needs a generator or noise")
        noise = uniform_noise(logits.shape, generator, logits.device)
    n = logistic_noise(noise.to(logits.dtype))
    t = torch.as_tensor(temperature, device=logits.device).to(logits.dtype)
    return torch.sigmoid((2.0 * logits - 1.0 + n) / t)
