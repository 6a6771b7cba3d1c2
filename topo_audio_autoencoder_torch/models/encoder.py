"""Audio encoder: PQMF bands -> conv stacks -> simplex logits -> complex.

Port of ``topo_audio_autoencoder_tpu.models.encoder`` for the eval path
(``sampler="gumbel"``, ``hard=False``, dense masked-static operators).

- The 16 per-band conv stacks are one grouped conv per stage (``groups`` =
  number of bands), channels band-major, so the per-band GroupNorm becomes
  one GroupNorm whose group boundaries land on the bands.
- Public functions take channels-last ``[B, T, C]`` like the JAX package;
  the convs run on the NCW transpose inside.
- Flax's LayerNorm and GroupNorm use eps 1e-6 and ``nn.gelu`` is the tanh
  approximation; the port sets both explicitly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.samplers import binary_gumbel
from ..topology.builder import SimplicialOperators, build_operators
from ..topology.complexes import ComplexTables
from ..topology.rectifier import RectifiedProbs, enforce_constraints
from .init import init_standard_module

FLAX_NORM_EPS = 1e-6


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def layer_norm(channels: int) -> nn.LayerNorm:
    return nn.LayerNorm(channels, eps=FLAX_NORM_EPS)


def group_norm(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=FLAX_NORM_EPS)


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, groups: int = 1) -> nn.Conv1d:
    return nn.Conv1d(
        cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2, groups=groups
    )


# (kernel, stride) of every conv between the PQMF bands and the MLP; the
# cross-band merge convs keep the length.
_TIME_CONVS = ((15, 2), (7, 2), (5, 2), (5, 1), (7, 1), (7, 4), (7, 2), (3, 2))


def frames_after_convs(band_length: int) -> int:
    """Time steps left for the MLP from ``band_length`` PQMF samples."""
    n = band_length
    for k, s in _TIME_CONVS:
        n = (n + 2 * ((k - 1) // 2) - k) // s + 1
    return n


class EncoderOutput(NamedTuple):
    logits: torch.Tensor  # [B, S_total] raw simplex logits (pre vertex bias)
    embeddings: tuple  # per-rank [B, S_r, C], zero rows when inactive
    ops: SimplicialOperators
    probs: RectifiedProbs  # per-rank output probabilities
    rectified: RectifiedProbs  # soft rectified probabilities
    masks: tuple  # per-rank {0,1} active masks [B, S_r]
    valid: torch.Tensor  # [B] bool: at least one active vertex
    l0: torch.Tensor  # [B] zeros for the Gumbel sampler


class BandEncoder(nn.Module):
    """Fused per-band conv stacks: [B, T, nb] -> [B, T/8, 16 nb]; band b
    owns channels [16b, 16b+16)."""

    def __init__(self, num_bands: int = 16):
        super().__init__()
        nb = num_bands
        self.conv0 = _conv(nb, 8 * nb, 15, 2, groups=nb)
        self.norm0 = group_norm(2 * nb, 8 * nb)
        self.conv1 = _conv(8 * nb, 16 * nb, 7, 2, groups=nb)
        self.norm1 = group_norm(4 * nb, 16 * nb)
        self.conv2 = _conv(16 * nb, 16 * nb, 5, 2, groups=nb)
        self.norm2 = group_norm(4 * nb, 16 * nb)

    def forward_ncw(self, x: torch.Tensor) -> torch.Tensor:
        x = gelu(self.norm0(self.conv0(x)))
        x = gelu(self.norm1(self.conv1(x)))
        return gelu(self.norm2(self.conv2(x)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_ncw(x.transpose(1, 2)).transpose(1, 2)


class AudioEncoder(nn.Module):
    """Waveform bands -> simplex logits -> rectified complex (eval path)."""

    def __init__(
        self,
        tables: ComplexTables,
        num_bands: int = 16,
        embedding_dim: int = 64,
        num_samples: int = 64000,
    ):
        super().__init__()
        self.tables = tables
        self.sizes = tables.sizes
        self.total_simplices = tables.total_simplices
        nb = num_bands
        self.band_encoder = BandEncoder(nb)
        # Cross-band merge; group counts as in the JAX package.
        self.cross0 = _conv(16 * nb, 12 * nb, 5, groups=4)
        self.cross_norm0 = group_norm(12, 12 * nb)
        self.cross1 = _conv(12 * nb, 8 * nb, 7)
        self.cross_norm1 = group_norm(8, 8 * nb)
        self.skip_weight = nn.Parameter(torch.tensor(0.1))
        # Temporal reduction
        self.red0 = _conv(8 * nb, 8 * nb, 7, 4, groups=8)
        self.red_norm0 = group_norm(8, 8 * nb)
        self.red1 = _conv(8 * nb, 8 * nb, 7, 2, groups=8)
        self.red_norm1 = group_norm(8, 8 * nb)
        self.red2 = _conv(8 * nb, 8 * nb, 3, 2)
        self.red_norm2 = group_norm(8, 8 * nb)
        # MLP to simplex logits; flax infers mlp0's input width from the
        # first call, the port from the clip length.
        flat = frames_after_convs(num_samples // nb) * 8 * nb
        self.mlp0 = nn.Linear(flat, 2048)
        self.mlp_norm0 = layer_norm(2048)
        self.mlp1 = nn.Linear(2048, 1024)
        self.mlp_norm1 = layer_norm(1024)
        self.mlp2 = nn.Linear(1024, self.total_simplices)
        self.vertex_bias = nn.Parameter(torch.tensor(2.0))
        for r in range(4):
            self.register_parameter(
                f"embed_rank{r}", nn.Parameter(torch.empty(self.sizes[r], embedding_dim))
            )
            self.add_module(f"embed_norm{r}", layer_norm(embedding_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.modules():
            init_standard_module(module, generator)
        with torch.no_grad():
            self.skip_weight.fill_(0.1)
            self.vertex_bias.fill_(2.0)
            for r in range(4):
                getattr(self, f"embed_rank{r}").normal_(0.0, 1.0, generator=generator)

    def compute_logits(self, bands: torch.Tensor, train: bool = False) -> torch.Tensor:
        """[B, T, num_bands] (channels-last PQMF bands) -> [B, S_total]."""
        if train:
            raise NotImplementedError(
                "encoder dropout belongs to the training slice of the PyTorch port"
            )
        x = self.band_encoder.forward_ncw(bands.transpose(1, 2))  # [B, 16nb, T/8]
        # Skip: max over adjacent channel pairs, 16nb -> 8nb channels.
        b, c, t = x.shape
        skip = x.reshape(b, c // 2, 2, t).amax(dim=2)
        y = gelu(self.cross_norm0(self.cross0(x)))
        y = gelu(self.cross_norm1(self.cross1(y)))
        y = y + self.skip_weight * skip
        y = gelu(self.red_norm0(self.red0(y)))
        y = gelu(self.red_norm1(self.red1(y)))
        y = gelu(self.red_norm2(self.red2(y)))  # [B, 8nb, frames]
        # Flatten in the JAX package's channels-last order.
        y = y.transpose(1, 2).reshape(b, -1)
        y = gelu(self.mlp_norm0(self.mlp0(y)))
        y = gelu(self.mlp_norm1(self.mlp1(y)))
        return self.mlp2(y)  # [B, S_total]

    def embed(self, probs: RectifiedProbs) -> tuple:
        """Masked-static embeddings: LN(table_r) * prob_r, per rank."""
        return tuple(
            getattr(self, f"embed_norm{r}")(getattr(self, f"embed_rank{r}"))
            * probs.ranks[r][..., None]
            for r in range(4)
        )

    def generate_complex(
        self, logits: torch.Tensor, temperature=1.0, train: bool = False
    ) -> EncoderOutput:
        """Threshold, rectify, embed and assemble the operators."""
        v = self.sizes[0]
        biased = torch.cat(
            [logits[..., :v] + F.relu(self.vertex_bias), logits[..., v:]], dim=-1
        )
        probs_all = binary_gumbel(biased, None, temperature, training=train)
        rect = enforce_constraints(*self.tables.split(probs_all), self.tables)
        masks = tuple((p > 0).to(logits.dtype) for p in rect.ranks)
        valid = rect.vertices.sum(dim=-1) > 0
        # Operators from the rectified probs, masks from the output probs
        # (the same tensors on this path).
        ops = build_operators(rect, self.tables, masks=masks)
        return EncoderOutput(
            logits=logits,
            embeddings=self.embed(rect),
            ops=ops,
            probs=rect,
            rectified=rect,
            masks=masks,
            valid=valid,
            l0=torch.zeros(logits.shape[:-1], dtype=logits.dtype, device=logits.device),
        )

    def forward(self, bands: torch.Tensor, temperature=1.0, train: bool = False) -> EncoderOutput:
        return self.generate_complex(self.compute_logits(bands, train), temperature, train)


def vertex_count_penalty(
    vertex_probs: torch.Tensor, min_active: int, max_active: int
) -> torch.Tensor:
    """relu(min - count) + relu(count - max)."""
    count = vertex_probs.sum(dim=-1)
    return F.relu(min_active - count) + F.relu(count - max_active)


def rank_diversity_entropy(probs: RectifiedProbs) -> torch.Tensor:
    """-0.1 * entropy of the mean activation across ranks, batched."""
    acts = torch.stack([p.mean(dim=-1) for p in probs.ranks], dim=-1)  # [B, 4]
    dist = acts / (acts.sum(dim=-1, keepdim=True) + 1e-10)
    entropy = -(dist * torch.log(dist + 1e-10)).sum(dim=-1)
    return -0.1 * entropy
