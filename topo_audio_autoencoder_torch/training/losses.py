"""Training objective: multiscale spectral distance plus regularizers.

Port of ``topo_audio_autoencoder_tpu.training.losses``. An invalid sample
(no active vertex) contributes the fixed ``invalid_state_penalty`` in place
of its reconstruction loss, through a per-sample ``where``. The span
``taa.loss.spectral`` (``utils.profiling``) covers ``autoencoder_loss``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.stft import DEFAULT_SCALES, spectral_distance
from ..utils.profiling import span


class LossWeights(NamedTuple):
    """Penalty weights."""

    binary_entropy_penalty: float = 1e-5
    complexity_penalty: float = 0.1
    contrastive_weight: float = 1.0
    invalid_state_penalty: float = 100.0
    # Hard Concrete expected-L0 weight; the Gumbel sampler's l0 term is zero.
    l0_penalty: float = 0.0


def autoencoder_loss(
    recon: torch.Tensor,  # [B, 1, T] reconstruction
    target: torch.Tensor,  # [B, 1, T]
    aux: dict,  # {'binary_entropy': [B], 'diversity': [B], optional 'l0': [B]}
    valid: torch.Tensor,  # [B] bool
    weights: LossWeights = LossWeights(),
    contrastive: torch.Tensor | None = None,  # scalar, optional
    scales=DEFAULT_SCALES,
    with_per_sample: bool = False,
    stft_method: str = "auto",
):
    """Total loss (0-d tensor) and a dict of 0-d component tensors.

    ``with_per_sample`` adds the [B] per-sample total under
    ``components["per_sample"]``.
    """
    with span("taa.loss.spectral"):
        spec = spectral_distance(recon[:, 0, :], target[:, 0, :], scales, method=stft_method)  # [B]
        per_sample = (
            spec
            + weights.binary_entropy_penalty * aux["binary_entropy"]
            + weights.complexity_penalty * aux["diversity"]
        )
        if weights.l0_penalty and "l0" in aux:
            per_sample = per_sample + weights.l0_penalty * aux["l0"]
        per_sample = torch.where(
            valid, per_sample, torch.full_like(per_sample, weights.invalid_state_penalty)
        )
        total = per_sample.mean()

        validf = valid.to(spec.dtype)
        components = {
            "spectral_loss": torch.where(valid, spec, torch.zeros_like(spec)).mean(),
            "binary_entropy_loss": aux["binary_entropy"].mean(),
            "diversity_loss": aux["diversity"].mean(),
            "invalid_fraction": 1.0 - validf.mean(),
        }
        if "l0" in aux:
            components["l0_loss"] = aux["l0"].mean()
        if contrastive is not None:
            total = total + weights.contrastive_weight * contrastive
            components["contrastive_loss"] = contrastive
        components["total_loss"] = total
        if with_per_sample:
            components["per_sample"] = per_sample
        return total, components
