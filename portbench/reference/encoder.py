"""Audio encoder: PQMF bands -> conv stacks -> simplex logits -> complex.

The binary Gumbel sampler, soft (``hard=False``), over dense or packed
operators (``pack_capacities``), in training and in eval.

- The 16 per-band conv stacks are one grouped conv per stage (``groups`` =
  number of bands), channels band-major, so the per-band GroupNorm becomes
  one GroupNorm whose group boundaries land on the bands.
- Public functions take channels-last ``[B, T, C]``; the convs run on the
  NCW transpose inside.
- LayerNorm and GroupNorm use eps 1e-6; gelu is the tanh approximation.
- Randomness: dropout masks from a torch generator on the device, the
  sampler's Philox seed from a CPU generator. In a row block (``shard``)
  every draw is made at the whole batch's shape and cut to the block.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from .builder import SimplicialOperators, build_operators
from .complexes import ComplexTables
from .packed import build_packed_operators
from .rectifier import RectifiedProbs, enforce_constraints
from .samplers import RowShard, binary_gumbel, rand_rows

FLAX_NORM_EPS = 1e-6


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def layer_norm(channels: int) -> nn.LayerNorm:
    return nn.LayerNorm(channels, eps=FLAX_NORM_EPS)


def group_norm(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=FLAX_NORM_EPS)


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None, shard: RowShard | None = None):
    """Inverted dropout: keep where ``u >= rate`` for uniforms ``u`` drawn
    from ``generator`` (the ``shard``'s rows of the batch's draw), and
    scale the kept values by 1 / (1 - rate)."""
    if rate == 0.0:
        return x
    keep = (rand_rows(x.shape, generator, shard) >= rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


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
    embeddings: tuple  # per-rank [B, S_r, C] (packed: [B, K_r, C]), zero rows when inactive
    ops: SimplicialOperators  # or PackedOperators
    rectified: RectifiedProbs  # rectified probabilities, full layout
    masks: tuple  # per-rank {0,1} active masks [B, S_r] (packed: [B, K_r])
    valid: torch.Tensor  # [B] bool: at least one active vertex


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
    """Waveform bands -> simplex logits -> rectified complex, with the
    binary Gumbel relaxation; ``pack_capacities`` (per-rank ints, 0 or
    None for a dense rank) packs the operators, embeddings and masks of the
    capacity-limited ranks."""

    def __init__(
        self,
        tables: ComplexTables,
        num_bands: int = 16,
        embedding_dim: int = 64,
        num_samples: int = 64000,
        dropout: float = 0.1,
        pack_capacities: tuple | None = None,
    ):
        super().__init__()
        self.dropout = dropout
        self.pack_capacities = tuple(pack_capacities) if pack_capacities is not None else None
        self.tables = tables
        self.sizes = tables.sizes
        self.total_simplices = tables.total_simplices
        nb = num_bands
        self.band_encoder = BandEncoder(nb)
        # Cross-band merge.
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
        # MLP to simplex logits, sized from the clip length.
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

    def compute_logits(self, bands: torch.Tensor, train: bool = False,
                       generator: torch.Generator | None = None, shard: RowShard | None = None) -> torch.Tensor:
        """[B, T, num_bands] (channels-last PQMF bands) -> [B, S_total]. In
        training, dropout after both hidden MLP layers, drawn from
        ``generator``."""
        rate = self.dropout if train else 0.0
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
        # Flatten channels-last.
        y = y.transpose(1, 2).reshape(b, -1)
        y = dropout(gelu(self.mlp_norm0(self.mlp0(y))), rate, generator, shard)
        y = dropout(gelu(self.mlp_norm1(self.mlp1(y))), rate, generator, shard)
        return self.mlp2(y)  # [B, S_total]

    def embed(self, probs: RectifiedProbs, idx=(None,) * 4) -> tuple:
        """Masked-static embeddings LN(table_r) * prob_r per rank; a packed
        rank (``idx[r]`` its top-K indices [B, K]) takes LN(table_r)[idx]
        times the gathered probabilities."""
        out = []
        for r in range(4):
            table = getattr(self, f"embed_norm{r}")(getattr(self, f"embed_rank{r}"))
            if idx[r] is None:
                out.append(table * probs.ranks[r][..., None])
            else:
                out.append(table[idx[r]] * torch.gather(probs.ranks[r], -1, idx[r])[..., None])
        return tuple(out)

    def operators(self, rect: RectifiedProbs, masks: tuple):
        """Dense operators, or packed ones when ``pack_capacities`` is set,
        selected by the key mask + rect (every active row before every
        inactive one)."""
        if self.pack_capacities is None:
            return build_operators(rect, self.tables, masks=masks)
        return build_packed_operators(
            rect, self.tables, self.pack_capacities, masks=masks,
            select_key=tuple(m + p for m, p in zip(masks, rect.ranks)),
        )

    def generate_complex(self, logits: torch.Tensor, temperature=1.0, train: bool = False,
                         generator: torch.Generator | None = None, shard: RowShard | None = None) -> EncoderOutput:
        """Sample (train) or relax without noise (eval), rectify, embed and
        assemble the operators. ``generator`` (CPU) gives the sampler's
        Philox seed."""
        v = self.sizes[0]
        biased = torch.cat([logits[..., :v] + F.relu(self.vertex_bias), logits[..., v:]], dim=-1)
        first = shard.first(biased.numel()) if shard is not None else 0
        probs_all = binary_gumbel(biased, generator, temperature, train, first)
        rect = enforce_constraints(*self.tables.split(probs_all), self.tables)
        masks = tuple((p > 0).to(logits.dtype) for p in rect.ranks)
        valid = rect.vertices.sum(dim=-1) > 0
        ops = self.operators(rect, masks)
        embeddings = self.embed(rect, ops.idx)
        return EncoderOutput(logits=logits, embeddings=embeddings, ops=ops, rectified=rect,
                             masks=ops.masks, valid=valid)


def info_nce_loss(logits: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """InfoNCE over simplex-logit rows. logits: [B, G, S], row 0 = anchor,
    1 = positive, 2: = negatives; cross-entropy with label 0."""
    norm = logits / (torch.linalg.vector_norm(logits, dim=-1, keepdim=True) + 1e-12)
    anchor, positive, negatives = norm[:, 0], norm[:, 1], norm[:, 2:]
    pos = torch.einsum("bs,bs->b", anchor, positive)[:, None]  # [B, 1]
    neg = torch.einsum("bs,bks->bk", anchor, negatives)  # [B, K]
    scores = torch.cat([pos, neg], dim=1) / temperature
    return (torch.logsumexp(scores, dim=1) - scores[:, 0]).mean()


def vertex_count_penalty(
    vertex_probs: torch.Tensor, min_active: int, max_active: int
) -> torch.Tensor:
    """relu(min - count) + relu(count - max)."""
    count = vertex_probs.sum(dim=-1)
    return F.relu(min_active - count) + F.relu(count - max_active)


def rank_diversity_entropy(probs: RectifiedProbs) -> torch.Tensor:
    """-0.1 * entropy of the mean activation across ranks, batched; ranks
    that ``max_rank`` truncation empties are left out."""
    acts = torch.stack([p.mean(dim=-1) for p in probs.ranks if p.shape[-1] > 0], dim=-1)  # [B, <=4]
    dist = acts / (acts.sum(dim=-1, keepdim=True) + 1e-10)
    entropy = -(dist * torch.log(dist + 1e-10)).sum(dim=-1)
    return -0.1 * entropy
