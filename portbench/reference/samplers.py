"""The binary Gumbel relaxation and its Philox4x32-10 uniforms, in plain
torch, and the row blocks a batch is computed in.

The uniforms are a function of (seed, element): element e is word e & 3 of
the Philox4x32-10 block of counter (e >> 2, offset) under the 64-bit key
``seed``, taken as ``(word >> 8) * 2^-24`` and clipped to [1e-6, 1 - 1e-6].
The relaxation is ``sigmoid((2l - 1 + log u - log(1 - u)) / T)`` computed
in fp32; eval thresholds the noiseless relaxation, ``l > 0.5``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

UNIFORM_MIN = 1e-6
UNIFORM_MAX = 1.0 - 1e-6
_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


@dataclass(frozen=True)
class RowShard:
    """Block ``index`` of ``count`` equal row blocks of a batch. Every
    random draw is made at the whole batch's shape and cut to the block's
    rows, so the blocks together draw what the whole batch draws."""

    index: int = 0
    count: int = 1

    def rows(self, draw, shape) -> torch.Tensor:
        n = shape[0]
        return draw((n * self.count, *shape[1:]))[self.index * n : (self.index + 1) * n]

    def first(self, numel: int) -> int:
        """Where this block starts in the flattened draw of the batch."""
        return self.index * numel


def rand_rows(shape, generator: torch.Generator, shard: RowShard | None = None) -> torch.Tensor:
    """``torch.rand`` of ``shape`` from ``generator`` on its own device; with
    ``shard``, the shard's rows of the draw at the batch's shape."""

    def draw(s):
        return torch.rand(s, generator=generator, device=generator.device)

    return draw(shape) if shard is None else shard.rows(draw, tuple(shape))


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit words of a * b for a 32-bit constant ``a`` and int64
    tensors holding 32-bit words, without overflowing int64."""
    a_hi, a_lo = a >> 16, a & 0xFFFF
    low = a_lo * b
    t = a_hi * b + (low >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (low & 0xFFFF)


def philox_uniform(numel: int, seed: int, offset: int = 0, device=None, first: int = 0) -> torch.Tensor:
    """fp32 uniforms of elements first .. first+numel-1 of the stream."""
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


def seed_from(generator: torch.Generator) -> int:
    """A 63-bit Philox seed drawn from a CPU ``generator``."""
    return int(torch.randint(0, 2**63 - 1, (), generator=generator).item())


def binary_gumbel(logits: torch.Tensor, generator: torch.Generator | None, temperature, train: bool,
                  first: int = 0) -> torch.Tensor:
    """Train: the relaxation on the Philox uniforms of a seed drawn from
    ``generator``, from element ``first``; eval: ``logits > 0.5``. Output
    in the logits' dtype."""
    if not train:
        return (logits > 0.5).to(logits.dtype)
    seed = seed_from(generator)
    u = philox_uniform(logits.numel(), seed, 0, logits.device, first).reshape(logits.shape)
    n = torch.log(u) - torch.log1p(-u)
    s = torch.sigmoid((2.0 * logits.to(torch.float32) - 1.0 + n) / float(temperature))
    return s.to(logits.dtype)
