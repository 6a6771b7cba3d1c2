"""Autoencoder facade: PQMF -> encoder -> complex -> decoder -> PQMF^-1.

Waveforms are NCW ``[B, 1, T]`` at the facade; internals are
channels-last. The parameter names are the port's, so one state dict
loads into either.
"""

from __future__ import annotations

import torch
from torch import nn

from .complexes import build_tables
from .decoder import AudioDecoder
from .encoder import AudioEncoder, EncoderOutput
from .pqmf import PQMF
from .rectifier import RectifiedProbs, enforce_constraints


class AudioAutoencoder(nn.Module):
    """Full model: PQMF analysis, encoder, complex, decoder, PQMF synthesis."""

    def __init__(
        self,
        num_vertices: int = 20,
        num_bands: int = 16,
        sccn_hidden_dim: int = 64,
        min_active_vertices: int = 8,
        max_active_vertices: int = 20,
        n_sccn_layers: int = 6,
        pqmf_attenuation: float = 100.0,
        num_samples: int = 64000,
        dropout: float = 0.1,
        pack_capacities: tuple | None = None,
    ):
        super().__init__()
        self.tables = build_tables(num_vertices)
        self.num_bands = num_bands
        self.min_active_vertices = min_active_vertices
        self.max_active_vertices = max_active_vertices
        self.pqmf = PQMF(attenuation=pqmf_attenuation, n_band=num_bands)
        self.encoder = AudioEncoder(self.tables, num_bands, sccn_hidden_dim, num_samples, dropout,
                                    pack_capacities=pack_capacities)
        self.decoder = AudioDecoder(sccn_hidden_dim=sccn_hidden_dim, initial_sequence_length=250,
                                    output_channels=num_bands, n_sccn_layers=n_sccn_layers,
                                    sizes=self.tables.sizes)

    def encode(self, x: torch.Tensor) -> EncoderOutput:
        """Eval: [B, 1, T] -> EncoderOutput (the noiseless relaxation)."""
        bands = self.pqmf(x)
        logits = self.encoder.compute_logits(bands.transpose(-1, -2))
        return self.encoder.generate_complex(logits)

    def decode(self, enc: EncoderOutput, desired_length: int, train: bool = False) -> torch.Tensor:
        """EncoderOutput -> [B, 1, T]; ``desired_length`` is the per-band
        (post-PQMF) length."""
        sub = self.decoder(enc.embeddings, enc.ops, enc.masks, desired_length, train)
        return self.pqmf.inverse(sub.transpose(-1, -2))

    def decode_from_probs(self, probs: RectifiedProbs, desired_length: int) -> torch.Tensor:
        """Eval decode from a per-rank latent: re-rectified, then embeddings
        and operators rebuilt from it alone."""
        rect = enforce_constraints(*probs.ranks, self.tables)
        masks = tuple((p > 0).to(p.dtype) for p in rect.ranks)
        ops = self.encoder.operators(rect, masks)
        embeddings = self.encoder.embed(rect, ops.idx)
        sub = self.decoder(embeddings, ops, ops.masks, desired_length, False)
        return self.pqmf.inverse(sub.transpose(-1, -2))
