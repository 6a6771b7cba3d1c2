"""Seeded parameter initialization in the flax init families.

The JAX package draws its weights with flax's default initializers. The
port draws from the same families (not the same numbers) with an explicit
``torch.Generator``: lecun-normal Dense/Conv/SCCN kernels (truncated
normal, variance 1/fan_in), zero biases, unit norm scales, normal(1.0)
embedding tables, orthogonal recurrent kernels.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# flax.linen.initializers.lecun_normal truncates at 2 std and rescales the
# standard deviation by this constant (the std of a unit normal truncated
# to [-2, 2]) so that the variance stays 1/fan_in.
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> torch.Tensor:
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(
            t, mean=0.0, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
        )


def orthogonal_(t: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax.linen.initializers.orthogonal: a random orthogonal matrix."""
    with torch.no_grad():
        return nn.init.orthogonal_(t, generator=generator)


def init_standard_module(module: nn.Module, generator: torch.Generator) -> None:
    """Flax defaults for the torch building blocks the port uses."""
    with torch.no_grad():
        if isinstance(module, (nn.Linear, nn.Conv1d)):
            lecun_normal_(module.weight, module.weight[0].numel(), generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, (nn.LayerNorm, nn.GroupNorm)):
            module.weight.fill_(1.0)
            module.bias.zero_()
