"""Stochastic binarization: the binary Gumbel relaxation, the Hard
Concrete gate, the temperature schedule and the straight-through
estimator.

Port of ``topo_audio_autoencoder_tpu.ops.samplers``. These are the plain
samplers, drawing their noise with ``torch.rand`` from an explicit
generator or taking it as a tensor; the encoder's default train path is the
fused kernels in ``ops.fused_samplers``.

Under data parallelism each rank holds a block of the global batch's rows
(``RowShard``): its draws are made at the global shape from the step's
generator, and it keeps its rows, so that D ranks draw what one process
draws for the whole batch.
"""

from __future__ import annotations

from dataclasses import dataclass

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


@dataclass(frozen=True)
class RowShard:
    """Block ``index`` of ``count`` equal row blocks of a global batch: the
    rows that one data-parallel rank holds."""

    index: int = 0
    count: int = 1

    def rows(self, draw, shape) -> torch.Tensor:
        """``draw(global shape)``, the leading axis ``count`` times
        ``shape[0]``, cut to this block's ``shape[0]`` rows."""
        n = shape[0]
        return draw((n * self.count, *shape[1:]))[self.index * n : (self.index + 1) * n]

    def first(self, numel: int) -> int:
        """Where this block starts in the flattened global draw, for a
        block of ``numel`` elements."""
        return self.index * numel


def rand_rows(shape, generator: torch.Generator, shard: RowShard | None = None) -> torch.Tensor:
    """``torch.rand`` of ``shape`` from ``generator`` on its own device; with
    ``shard``, the shard's rows of the draw at the global shape."""

    def draw(s):
        return torch.rand(s, generator=generator, device=generator.device)

    return draw(shape) if shard is None else shard.rows(draw, tuple(shape))


def uniform_noise(shape, generator: torch.Generator, device, shard: RowShard | None = None) -> torch.Tensor:
    """fp32 uniforms on [1e-6, 1 - 1e-6] from ``generator``, on ``device``
    (drawn on the generator's own device, then moved); with ``shard``, its
    rows of the draw at the global shape."""
    u = rand_rows(shape, generator, shard)
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
    shard: RowShard | None = None,
) -> torch.Tensor:
    """Binary Gumbel-softmax relaxation.

    Train mode: ``sigmoid((2l - 1 + logistic(u)) / T)`` with ``u`` uniform
    on [1e-6, 1 - 1e-6], drawn from ``generator`` (the ``shard``'s rows of
    the global draw) or given as ``noise`` (a tensor of uniforms of the
    logits' shape). It computes in the logits'
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
        noise = uniform_noise(logits.shape, generator, logits.device, shard)
    n = logistic_noise(noise.to(logits.dtype))
    t = torch.as_tensor(temperature, device=logits.device).to(logits.dtype)
    return torch.sigmoid((2.0 * logits - 1.0 + n) / t)


@dataclass(frozen=True)
class HardConcreteParams:
    """Stretch of the Hard Concrete gate (Louizos et al. 2018, section 4).

    ``gamma``/``zeta`` may also be tensors broadcastable against log-alpha:
    the encoder's learned per-rank stretch passes per-simplex [S] rows.
    """

    gamma: float | torch.Tensor = -0.1
    zeta: float | torch.Tensor = 1.1


def hard_concrete(
    log_alpha: torch.Tensor,
    generator: torch.Generator | None,
    temperature,
    params: HardConcreteParams = HardConcreteParams(),
    training: bool = True,
    noise: torch.Tensor | None = None,
    shard: RowShard | None = None,
) -> torch.Tensor:
    """Hard Concrete relaxation of a Bernoulli gate.

    train: ``s = sigmoid((logistic(u) + log_alpha) / T)``, ``u`` drawn from
    ``generator`` (the ``shard``'s rows of the global draw) or given as
    ``noise``; eval: ``s = sigmoid(log_alpha)``;
    both ``z = clip(s (zeta - gamma) + gamma, 0, 1)``. Exactly 0 or 1 with
    positive probability. Computes in log-alpha's dtype (the temperature,
    a scalar or a per-simplex row, is cast to it).
    """
    g, z_ = params.gamma, params.zeta
    if training:
        if noise is None:
            if generator is None:
                raise ValueError("hard_concrete(training=True) needs a generator or noise")
            noise = uniform_noise(log_alpha.shape, generator, log_alpha.device, shard)
        n = logistic_noise(noise.to(log_alpha.dtype))
        t = torch.as_tensor(temperature, device=log_alpha.device).to(log_alpha.dtype)
        s = torch.sigmoid((n + log_alpha) / t)
    else:
        s = torch.sigmoid(log_alpha)
    return torch.clamp(s * (z_ - g) + g, 0.0, 1.0)


def hard_concrete_l0_penalty(
    log_alpha: torch.Tensor, temperature, params: HardConcreteParams = HardConcreteParams()
) -> torch.Tensor:
    """Expected L0: the probability that each gate is nonzero,
    ``sigmoid(log_alpha - T log(-gamma / zeta))``."""
    g, z_ = params.gamma, params.zeta
    ratio = -g / z_
    if not isinstance(ratio, torch.Tensor):
        ratio = torch.tensor(ratio, dtype=torch.float32)
    t = torch.as_tensor(temperature, device=log_alpha.device)
    return torch.sigmoid(log_alpha - t * torch.log(ratio.to(log_alpha.device)))


def bernoulli_ste(
    probs: torch.Tensor, logits: torch.Tensor, u: torch.Tensor
) -> torch.Tensor:
    """Bernoulli sample of ``probs`` (``u < probs`` for uniforms ``u`` on
    [0, 1), as ``jax.random.bernoulli`` draws) with the gradient routed to
    ``logits``."""
    hard = (u.to(probs.dtype) < probs).to(probs.dtype)
    return straight_through(hard, logits)
