"""The reference train step: the port's contrastive objective, its
optimizer (global-norm clip at 10, two-group Adam with optax's formulas)
and its randomness from (seed, step), in plain torch.

The step runs over the batch in ``blocks`` equal row blocks, each drawing
its randomness at the whole batch's shape and keeping its rows: every term
of the loss is a mean over rows, so the mean of the blocks' losses and
gradients is the batch's. ``cast`` maps a parameter or an input to the
precision the step computes in (identity for the fp32 reference; the
control rounds through a lower precision).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from .autoencoder import AudioAutoencoder
from .encoder import info_nce_loss, rank_diversity_entropy, vertex_count_penalty
from .losses import LossWeights, autoencoder_loss
from .samplers import RowShard

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
ENCODER_LR = 1e-3
DECODER_LR = 1e-4
MAX_NORM = 10.0


def step_generators(seed: int, step: int, device) -> tuple:
    """The step's generators, a function of (seed, step) alone: a CPU
    generator for the sampler's Philox seed and one on ``device`` for the
    dropout masks."""
    sample_seed, dropout_seed = np.random.SeedSequence([seed, step]).generate_state(2, np.uint64)
    sample = torch.Generator(device="cpu").manual_seed(int(sample_seed))
    dropout = torch.Generator(device=device).manual_seed(int(dropout_seed))
    return sample, dropout


class Objective(nn.Module):
    """The loss of one contrastive batch [B, G, 1, T]: every clip through
    PQMF and the logits, InfoNCE over the fp32 logits when G >= 3, and only
    the anchors (row 0) sampled, rectified and decoded."""

    def __init__(self, model: AudioAutoencoder, weights: LossWeights = LossWeights()):
        super().__init__()
        self.model = model
        self.weights = weights

    def forward(self, batch, temperature, sample_gen, dropout_gen, shard):
        model = self.model
        b, g, _, t = batch.shape
        flat = batch.reshape(b * g, 1, t)
        bands = model.pqmf(flat)
        logits = model.encoder.compute_logits(bands.transpose(-1, -2), True, dropout_gen, shard)
        contrastive = info_nce_loss(logits.reshape(b, g, -1).to(torch.float32)) if g >= 3 else None
        anchor_logits = logits.reshape(b, g, -1)[:, 0]
        enc = model.encoder.generate_complex(anchor_logits, temperature, True, sample_gen, shard)
        anchors = flat.reshape(b, g, 1, t)[:, 0]
        recon = model.decode(enc, t // model.num_bands, True)
        aux = {
            "binary_entropy": rank_diversity_entropy(enc.rectified),
            "diversity": vertex_count_penalty(enc.rectified.vertices, model.min_active_vertices,
                                              model.max_active_vertices),
        }
        return autoencoder_loss(recon.to(torch.float32), anchors.to(torch.float32),
                                {k: v.to(torch.float32) for k, v in aux.items()}, enc.valid, self.weights,
                                contrastive)


def loss_and_grads(model: AudioAutoencoder, batch, temperature: float, seed: int, step: int,
                   blocks: int = 1, cast=None):
    """The step's loss components (floats, ``total_loss`` among them) and
    fp32 gradients by parameter name.
    ``cast(tensor)`` is applied to every parameter and to the batch before
    the forward."""
    objective = Objective(model)
    params = dict(model.named_parameters())
    if batch.shape[0] % blocks:
        raise ValueError(f"{batch.shape[0]} rows do not split into {blocks} blocks")
    rows = batch.shape[0] // blocks
    components: dict = {}
    grads = {n: torch.zeros_like(p) for n, p in params.items()}
    for i in range(blocks):
        sample_gen, dropout_gen = step_generators(seed, step, batch.device)
        part = batch[i * rows : (i + 1) * rows]
        shard = RowShard(i, blocks) if blocks > 1 else None
        cast_params = {f"model.{n}": (cast(p) if cast else p) for n, p in params.items()}
        loss, parts = torch.func.functional_call(
            objective, cast_params,
            (cast(part) if cast else part, float(temperature), sample_gen, dropout_gen, shard),
        )
        got = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        for (n, _), gr in zip(params.items(), got):
            if gr is not None:
                grads[n] += gr.to(torch.float32) / blocks
        for k, v in parts.items():
            components[k] = components.get(k, 0.0) + float(v.detach()) / blocks
        del loss, got
    return components, grads


class Adam:
    """Global-norm clip at ``MAX_NORM`` (scale by max_norm / norm when
    norm >= max_norm), then Adam per leaf at the encoder's learning rate for
    ``encoder.*`` and the decoder's for the rest, in optax's formulas."""

    def __init__(self, params: dict):
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @staticmethod
    def clip(grads: dict) -> dict:
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        if float(norm) < MAX_NORM:
            return grads
        return {n: g / norm * MAX_NORM for n, g in grads.items()}

    @torch.no_grad()
    def apply(self, grads: dict, params: dict) -> None:
        self.count += 1
        bc1 = float(1.0 - torch.tensor(ADAM_B1) ** self.count)
        bc2 = float(1.0 - torch.tensor(ADAM_B2) ** self.count)
        for n, g in grads.items():
            self.mu[n] = (1.0 - ADAM_B1) * g + ADAM_B1 * self.mu[n]
            self.nu[n] = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * self.nu[n]
            update = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2) + ADAM_EPS)
            lr = ENCODER_LR if n.startswith("encoder.") else DECODER_LR
            params[n].add_(update * -lr)


def leaf_norms(tensors: dict) -> dict:
    """The L2 norm of each tensor, as floats."""
    return {n: float(torch.linalg.vector_norm(t.to(torch.float32))) for n, t in tensors.items()}


def readings(model: AudioAutoencoder, batches, temperature: float, seed: int, blocks: int = 1,
             cast=None) -> dict:
    """Drive ``len(batches)`` steps from the model's current parameters and
    read what the check compares: each step's loss components, the norm of
    each leaf's first clipped gradient, the norm of each leaf's change
    after the last step, and each leaf's element count."""
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    adam = Adam(params)
    losses, first_grad = [], None
    for step, batch in enumerate(batches):
        parts, grads = loss_and_grads(model, batch, temperature, seed, step, blocks, cast)
        grads = adam.clip(grads)
        if first_grad is None:
            first_grad = leaf_norms(grads)
        adam.apply(grads, params)
        losses.append(parts)
        del grads
    change = leaf_norms({n: p.detach() - start[n] for n, p in params.items()})
    return {"losses": losses, "grad_norms": first_grad, "change_norms": change,
            "numel": {n: p.numel() for n, p in params.items()}}
