"""Autoencoder facade: PQMF -> encoder -> complex -> decoder -> PQMF^-1.

Port of ``topo_audio_autoencoder_tpu.models.autoencoder`` for both
samplers (binary Gumbel, Hard Concrete with a fixed or learned stretch),
the soft and the straight-through ``hard`` paths, and the dense
masked-static operators, in training (``train=True``: dropout, the sampled
relaxation, the SCCN's LayerNorms) and in eval (the noiseless relaxation).
Waveforms are NCW ``[B, 1, T]`` at the facade; internals are
channels-last. Packed operators, jumping knowledge and ``max_rank``
truncation are not ported: ``create`` refuses them as unknown arguments.

``AudioAutoencoder.create`` builds the model on ``cuda`` unless the caller
passes ``device="cpu"``, and raises when no card is present and none was
asked for.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..device import resolve_device
from ..ops.pqmf import PQMF
from ..topology.builder import build_operators
from ..topology.complexes import ComplexTables, build_tables
from ..topology.rectifier import RectifiedProbs, enforce_constraints
from .decoder import AudioDecoder
from .encoder import (
    AudioEncoder,
    EncoderOutput,
    rank_diversity_entropy,
    vertex_count_penalty,
)

DEFAULT_SEED = 511990


class AutoencoderOutput(NamedTuple):
    waveform: torch.Tensor  # [B, 1, T] reconstruction
    aux: dict  # {'binary_entropy': [B], 'diversity': [B], 'l0': [B]}
    valid: torch.Tensor  # [B] bool
    encoder_output: EncoderOutput


class AudioAutoencoder(nn.Module):
    """Full model: PQMF analysis, encoder, complex, decoder, PQMF synthesis."""

    def __init__(
        self,
        tables: ComplexTables,
        num_bands: int = 16,
        sccn_hidden_dim: int = 64,
        min_active_vertices: int = 8,
        max_active_vertices: int = 20,
        n_sccn_layers: int = 6,
        pqmf_attenuation: float = 100.0,
        num_samples: int = 64000,
        dropout: float = 0.1,
        use_fused_sampler: bool = True,
        hard: bool = False,
        sampler: str = "gumbel",
        learned_hc: bool = False,
    ):
        super().__init__()
        self.tables = tables
        self.num_bands = num_bands
        self.sccn_hidden_dim = sccn_hidden_dim
        self.min_active_vertices = min_active_vertices
        self.max_active_vertices = max_active_vertices
        self.n_sccn_layers = n_sccn_layers
        self.num_samples = num_samples
        self.pqmf = PQMF(attenuation=pqmf_attenuation, n_band=num_bands)
        self.encoder = AudioEncoder(
            tables, num_bands, sccn_hidden_dim, num_samples, dropout, use_fused_sampler,
            hard=hard, sampler=sampler, learned_hc=learned_hc,
        )
        self.decoder = AudioDecoder(
            sccn_hidden_dim=sccn_hidden_dim,
            initial_sequence_length=250,
            output_channels=num_bands,
            n_sccn_layers=n_sccn_layers,
        )

    @classmethod
    def create(
        cls,
        num_vertices: int = 20,
        num_bands: int = 16,
        sccn_hidden_dim: int = 64,
        min_active_vertices: int = 8,
        max_active_vertices: int = 20,
        n_sccn_layers: int = 6,
        pqmf_attenuation: float = 100.0,
        num_samples: int = 64000,
        seed: int = DEFAULT_SEED,
        device=None,
        dropout: float = 0.1,
        use_fused_sampler: bool = True,
        hard: bool = False,
        sampler: str = "gumbel",
        learned_hc: bool = False,
    ) -> "AudioAutoencoder":
        """Build tables, filterbank and seeded weights, on ``device``
        (default ``cuda``). ``num_samples`` is the clip length the encoder's
        MLP is sized for (flax infers it from the first call). ``dropout``,
        ``use_fused_sampler``, ``hard``, ``sampler`` and ``learned_hc`` have
        the JAX package's defaults and meanings."""
        device = resolve_device(device)
        model = cls(
            tables=build_tables(num_vertices),
            num_bands=num_bands,
            sccn_hidden_dim=sccn_hidden_dim,
            min_active_vertices=min_active_vertices,
            max_active_vertices=max_active_vertices,
            n_sccn_layers=n_sccn_layers,
            pqmf_attenuation=pqmf_attenuation,
            num_samples=num_samples,
            dropout=dropout,
            use_fused_sampler=use_fused_sampler,
            hard=hard,
            sampler=sampler,
            learned_hc=learned_hc,
        )
        model.reset_parameters(seed)
        return model.to(device).eval()

    def reset_parameters(self, seed: int = DEFAULT_SEED) -> None:
        """Fresh weights from ``seed`` in the flax init families (drawn on
        the CPU, so a seed gives the same weights on every device)."""
        generator = torch.Generator(device="cpu").manual_seed(seed)
        device = next(self.parameters()).device
        self.to("cpu")
        self.encoder.reset_parameters(generator)
        self.decoder.reset_parameters(generator)
        self.to(device)

    def encode(
        self,
        x: torch.Tensor,
        temperature=1.0,
        train: bool = False,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
        hard_noise=None,
    ) -> EncoderOutput:
        """[B, 1, T] -> EncoderOutput. In training, ``generator`` draws the
        dropout masks and the sampler's seed; ``noise`` (uniforms [B, S])
        replaces the sampler's draw. With ``hard``, ``generator`` (in eval
        too) or ``hard_noise`` (four per-rank uniform tensors) gives the
        Bernoulli draws; with neither they threshold at 0.5."""
        bands = self.pqmf(x)  # [B, M, T/M]
        return self.encoder(bands.transpose(-1, -2), temperature, train, generator, noise, hard_noise)

    def decode(
        self, enc: EncoderOutput, desired_length: int | None = None, train: bool = False
    ) -> torch.Tensor:
        """EncoderOutput -> [B, 1, T]. ``desired_length`` is the per-band
        (post-PQMF) length."""
        sub = self.decoder(enc.embeddings, enc.ops, enc.masks, desired_length, train)
        return self.pqmf.inverse(sub.transpose(-1, -2))

    def decode_from_probs(
        self, probs: RectifiedProbs, desired_length: int | None = None, train: bool = False
    ) -> torch.Tensor:
        """Decode straight from a per-rank probability latent: embeddings and
        operators are rebuilt from the latent alone. The latent is
        re-rectified first: idempotent on valid latents, and it restores
        face closure to a thresholded Hard Concrete latent."""
        rect = enforce_constraints(*probs.ranks, self.tables)
        masks = tuple((p > 0).to(p.dtype) for p in rect.ranks)
        ops = build_operators(rect, self.tables, masks=masks)
        sub = self.decoder(self.encoder.embed(rect), ops, masks, desired_length, train)
        return self.pqmf.inverse(sub.transpose(-1, -2))

    def geometry(self) -> dict:
        """Architecture facts a checkpoint consumer needs to rebuild the model."""
        return {
            "vertices": self.tables.num_vertices,
            "bands": self.num_bands,
            "hidden": self.sccn_hidden_dim,
            "layers": self.n_sccn_layers,
            "sampler": self.encoder.sampler,
            "hard": self.encoder.hard,
            "learned_hc": self.encoder.learned_hc,
            "min_active_vertices": self.min_active_vertices,
            "max_active_vertices": self.max_active_vertices,
            "pack_capacities": None,
        }

    def forward(
        self,
        x: torch.Tensor,
        temperature=1.0,
        train: bool = False,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
        hard_noise=None,
    ) -> AutoencoderOutput:
        enc = self.encode(x, temperature, train, generator, noise, hard_noise)
        wav = self.decode(enc, x.shape[-1] // self.num_bands, train)
        aux = {
            "binary_entropy": rank_diversity_entropy(enc.rectified),
            "diversity": vertex_count_penalty(
                enc.rectified.vertices, self.min_active_vertices, self.max_active_vertices
            ),
            "l0": enc.l0,
        }
        return AutoencoderOutput(waveform=wav, aux=aux, valid=enc.valid, encoder_output=enc)

    def num_params(self) -> int:
        """Total parameter count."""
        return sum(p.numel() for p in self.parameters())
