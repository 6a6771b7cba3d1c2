"""Stochastic binarization: the eval branch of the binary Gumbel relaxation.

Port of ``topo_audio_autoencoder_tpu.ops.samplers.binary_gumbel`` for
``training=False``. The train branch (logistic noise and its fused kernel)
belongs to the training slice of the port and is not implemented yet.
"""

from __future__ import annotations

import torch


def binary_gumbel(
    logits: torch.Tensor,
    generator: torch.Generator | None,
    temperature,
    training: bool = True,
) -> torch.Tensor:
    """Binary Gumbel-softmax relaxation.

    Eval mode thresholds the noiseless relaxation at 0.5, which reduces to
    ``logits > 0.5``.
    """
    if training:
        raise NotImplementedError(
            "binary_gumbel(training=True) belongs to the training slice of "
            "the PyTorch port and is not implemented yet"
        )
    return (logits > 0.5).to(logits.dtype)
