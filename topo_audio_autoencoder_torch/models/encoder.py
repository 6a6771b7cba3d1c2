"""Audio encoder: PQMF bands -> conv stacks -> simplex logits -> complex.

Port of ``topo_audio_autoencoder_tpu.models.encoder`` for both samplers
(binary Gumbel and Hard Concrete, with a fixed or a learned per-rank
stretch), the soft and the straight-through ``hard`` paths, and the dense
masked-static or the packed operators (``pack_capacities``), in training
and in eval.

- The 16 per-band conv stacks are one grouped conv per stage (``groups`` =
  number of bands), channels band-major, so the per-band GroupNorm becomes
  one GroupNorm whose group boundaries land on the bands.
- Public functions take channels-last ``[B, T, C]`` like the JAX package;
  the convs run on the NCW transpose inside.
- Flax's LayerNorm and GroupNorm use eps 1e-6 and ``nn.gelu`` is the tanh
  approximation; the port sets both explicitly.
- Randomness comes from explicit ``torch.Generator``s (dropout in the MLP,
  the sampler's seed, the hard path's Bernoulli draws) or from injected
  uniforms (``noise=`` for the relaxation, ``hard_noise=`` for the four
  per-rank Bernoulli draws): flax's streams cannot be reproduced in torch.
- Under data parallelism (``shard=``, a ``RowShard``) every draw is made at
  the global batch's shape and the rank keeps its rows: the fused samplers
  start their Philox stream at the rank's first element, the other draws
  cut the global ``torch.rand``. D ranks draw what one process draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.fused_hard_concrete import hard_concrete_fused_diff, hard_concrete_fused_learned_diff
from ..ops.fused_samplers import binary_gumbel_fused_diff
from ..ops.samplers import (
    HardConcreteParams,
    RowShard,
    binary_gumbel,
    hard_concrete,
    hard_concrete_l0_penalty,
    rand_rows,
    straight_through,
)
from ..topology.builder import SimplicialOperators, build_operators
from ..topology.complexes import ComplexTables
from ..topology.packed import build_packed_operators
from ..topology.rectifier import RectifiedProbs, enforce_constraints
from .init import init_standard_module

FLAX_NORM_EPS = 1e-6


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def layer_norm(channels: int) -> nn.LayerNorm:
    return nn.LayerNorm(channels, eps=FLAX_NORM_EPS)


def group_norm(groups: int, channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(groups, channels, eps=FLAX_NORM_EPS)


def dropout(
    x: torch.Tensor, rate: float, generator: torch.Generator | None, noise: torch.Tensor | None = None,
    shard: RowShard | None = None,
) -> torch.Tensor:
    """Inverted dropout as ``flax.linen.Dropout``: keep with probability
    1 - rate and scale the kept values by 1 / (1 - rate). The keep mask is
    ``u >= rate`` for uniforms ``u``: ``noise`` when given (x's shape), else
    drawn from ``generator`` on its own device (the ``shard``'s rows of the
    global draw)."""
    if rate == 0.0:
        return x
    if noise is None:
        if generator is None:
            raise ValueError("dropout in training needs a generator or noise")
        noise = rand_rows(x.shape, generator, shard)
    keep = (noise >= rate).to(x.device)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class _RowGather(torch.autograd.Function):
    """``table[idx]``: the rows of ``table`` [S, C] named by ``idx``
    [..., K] -> [..., K, C], where each row of ``idx`` names distinct
    table rows (top-K indices). The backward writes each row of ``idx``'s
    cotangents into a zero [S, C] block of its own (no collisions within a
    row) and sums the blocks over the leading axes in a fixed order:
    autograd's own backward of the index adds a table row selected by
    several samples with atomics on the card, in an order that changes from
    run to run, and the step would not repeat its gradients bit for bit.
    Under ``torch.func.vmap`` both the forward and the backward are
    vmapped as written (a vmapped table: one [S, C] block per combo)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(table, idx):
        return table[idx]

    @staticmethod
    def setup_context(ctx, inputs, output):
        table, idx = inputs
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        k, c = idx.shape[-1], g.shape[-1]
        rows = g.reshape(-1, k, c)
        index = idx.reshape(-1, k, 1).expand(-1, -1, c)
        blocks = torch.zeros(rows.shape[0], ctx.rows, c, dtype=g.dtype, device=g.device)
        return blocks.scatter(1, index, rows).sum(dim=0), None


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
    probs: RectifiedProbs  # per-rank output probabilities (STE'd if hard), full layout
    rectified: RectifiedProbs  # soft rectified probabilities, full layout
    masks: tuple  # per-rank {0,1} active masks [B, S_r] (packed: [B, K_r])
    valid: torch.Tensor  # [B] bool: at least one active vertex
    l0: torch.Tensor  # [B] expected share of open Hard Concrete gates; zeros for Gumbel


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


def _inv_softplus(x: float) -> float:
    return float(np.log(np.expm1(x)))


# The learned stretch's raw parameters and their inits: softplus of each
# gives the fixed stretch (beta = 2/3 per Louizos et al. 2018, -gamma =
# 0.1, zeta - 1 = 0.1), so an untrained learned_hc model samples as the
# fixed-stretch one does.
HC_RAW_INIT = {"hc_beta_raw": 2.0 / 3.0, "hc_gamma_raw": 0.1, "hc_zeta_raw": 0.1}


class AudioEncoder(nn.Module):
    """Waveform bands -> simplex logits -> rectified complex.

    ``sampler`` is ``"gumbel"`` (binary Gumbel) or ``"hard_concrete"``;
    ``learned_hc`` learns the Hard Concrete stretch per rank; ``hard``
    Bernoulli-samples (or, without randomness, thresholds) the rectified
    probabilities, re-rectifies, and straight-throughs to the logits.
    ``use_fused_sampler`` (the default, as in the JAX package) samples the
    train-mode relaxation through ``ops.fused_samplers`` or
    ``ops.fused_hard_concrete`` (CUDA kernels on the card); ``False`` takes
    the plain samplers of ``ops.samplers``. ``pack_capacities`` (per-rank
    ints, 0 or None for a dense rank) packs the operators, embeddings and
    masks of the capacity-limited ranks (``topology.packed``).
    """

    def __init__(
        self,
        tables: ComplexTables,
        num_bands: int = 16,
        embedding_dim: int = 64,
        num_samples: int = 64000,
        dropout: float = 0.1,
        use_fused_sampler: bool = True,
        hard: bool = False,
        sampler: str = "gumbel",
        learned_hc: bool = False,
        pack_capacities: tuple | None = None,
    ):
        super().__init__()
        if sampler not in ("gumbel", "hard_concrete"):
            raise ValueError(f"sampler must be 'gumbel' or 'hard_concrete', got {sampler!r}")
        if learned_hc and sampler != "hard_concrete":
            raise ValueError("learned_hc requires sampler='hard_concrete'")
        self.dropout = dropout
        self.use_fused_sampler = use_fused_sampler
        self.hard = hard
        self.sampler = sampler
        self.learned_hc = learned_hc
        self.pack_capacities = tuple(pack_capacities) if pack_capacities is not None else None
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
        if learned_hc:
            for name in HC_RAW_INIT:
                self.register_parameter(name, nn.Parameter(torch.empty(4)))

    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.modules():
            init_standard_module(module, generator)
        with torch.no_grad():
            self.skip_weight.fill_(0.1)
            self.vertex_bias.fill_(2.0)
            for r in range(4):
                getattr(self, f"embed_rank{r}").normal_(0.0, 1.0, generator=generator)
            if self.learned_hc:
                for name, value in HC_RAW_INIT.items():
                    getattr(self, name).fill_(_inv_softplus(value))

    def _hc_stretch(self, dtype: torch.dtype) -> tuple:
        """Per-simplex (beta, gamma, zeta) rows [S] from the per-rank raw
        parameters: softplus-constrained (beta > 0, gamma < 0, zeta > 1),
        cast to ``dtype``, repeated by rank size."""
        reps = torch.as_tensor(self.sizes, device=self.hc_beta_raw.device)

        def expand(v):
            return torch.repeat_interleave(v.to(dtype), reps, output_size=self.total_simplices)

        return (
            expand(F.softplus(self.hc_beta_raw)),
            expand(-F.softplus(self.hc_gamma_raw)),
            expand(1.0 + F.softplus(self.hc_zeta_raw)),
        )

    def compute_logits(
        self,
        bands: torch.Tensor,
        train: bool = False,
        generator: torch.Generator | None = None,
        dropout_noise: tuple | None = None,
        shard: RowShard | None = None,
    ) -> torch.Tensor:
        """[B, T, num_bands] (channels-last PQMF bands) -> [B, S_total].
        In training, dropout after both hidden MLP layers, drawn from
        ``generator`` (the ``shard``'s rows of the global draw), or from
        ``dropout_noise``: the two layers' uniforms ([B, 2048] and
        [B, 1024]), as ``generator`` would draw them."""
        noise0, noise1 = dropout_noise if dropout_noise is not None else (None, None)
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
        # Flatten in the JAX package's channels-last order.
        y = y.transpose(1, 2).reshape(b, -1)
        y = dropout(gelu(self.mlp_norm0(self.mlp0(y))), rate, generator, noise0, shard)
        y = dropout(gelu(self.mlp_norm1(self.mlp1(y))), rate, generator, noise1, shard)
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
                out.append(_RowGather.apply(table, idx[r]) * torch.gather(probs.ranks[r], -1, idx[r])[..., None])
        return tuple(out)

    def operators(self, rect: RectifiedProbs, masks: tuple):
        """The operator set from the soft rectified probs and the output
        masks: dense, or packed when ``pack_capacities`` is set, with the
        select key mask + rect (every active row before every inactive
        one)."""
        if self.pack_capacities is None:
            return build_operators(rect, self.tables, masks=masks)
        return build_packed_operators(
            rect, self.tables, self.pack_capacities, masks=masks,
            select_key=tuple(m + p for m, p in zip(masks, rect.ranks)),
        )

    def _relax(self, biased, temperature, train, generator, noise, stretch, shard=None) -> torch.Tensor:
        """The stochastic relaxation of every biased logit, in the JAX
        package's branch order (train: sampled; eval: noiseless).
        ``stretch``: the learned (beta, gamma, zeta) rows, or None;
        ``shard``: the rows of the global draw this rank keeps, or None."""
        fused = self.use_fused_sampler and train
        first = shard.first(biased.numel()) if shard is not None else 0
        if self.sampler == "hard_concrete":
            if stretch is not None:
                beta, gamma, zeta = stretch
                if fused:
                    return hard_concrete_fused_learned_diff(biased, generator, beta, gamma, zeta, True, noise, first)
                return hard_concrete(biased, generator, beta, HardConcreteParams(gamma, zeta), train, noise, shard)
            if fused:
                return hard_concrete_fused_diff(biased, generator, temperature, True, noise, first)
            return hard_concrete(biased, generator, temperature, training=train, noise=noise, shard=shard)
        if self.hard:
            # The reference's hard path relaxes without noise before its
            # Bernoulli draw.
            t = torch.as_tensor(temperature, device=biased.device).to(biased.dtype)
            return torch.sigmoid(biased / t)
        if fused:
            return binary_gumbel_fused_diff(biased, generator, temperature, True, noise, first)
        return binary_gumbel(biased, generator, temperature, train, noise, shard)

    def _hard_ranks(self, rect: RectifiedProbs, generator, hard_noise, shard=None) -> tuple:
        """Per-rank Bernoulli draws of the rectified probabilities: ``u < p``
        on the uniforms ``hard_noise`` (four tensors) or drawn from
        ``generator`` (the ``shard``'s rows of the global draw); with
        neither, a threshold at 0.5."""
        if hard_noise is None and generator is None:
            return tuple((p > 0.5).to(p.dtype) for p in rect.ranks)
        if hard_noise is None:
            hard_noise = [rand_rows(p.shape, generator, shard) for p in rect.ranks]
        return tuple(
            (u.to(device=p.device, dtype=p.dtype) < p).to(p.dtype) for u, p in zip(hard_noise, rect.ranks)
        )

    def generate_complex(
        self,
        logits: torch.Tensor,
        temperature=1.0,
        train: bool = False,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
        hard_noise=None,
        hard_generator: torch.Generator | None = None,
        shard: RowShard | None = None,
    ) -> EncoderOutput:
        """Sample (train) or relax without noise (eval), rectify, embed and
        assemble the operators.

        The relaxation's uniforms come from ``noise`` when given, else from
        ``generator``. With ``hard``, the Bernoulli draws come from
        ``hard_noise`` (four uniform tensors, one per rank) when given, else
        from ``hard_generator`` or ``generator``, in eval as in training;
        with neither they threshold at 0.5. With ``shard`` the logits are a
        data-parallel rank's rows, and each generator draw is that rank's
        rows of the global batch's draw.
        """
        v = self.sizes[0]
        biased = torch.cat(
            [logits[..., :v] + F.relu(self.vertex_bias), logits[..., v:]], dim=-1
        )
        stretch = self._hc_stretch(biased.dtype) if self.learned_hc else None
        probs_all = self._relax(biased, temperature, train, generator, noise, stretch, shard)
        rect = enforce_constraints(*self.tables.split(probs_all), self.tables)
        if self.hard:
            draw = hard_generator if hard_generator is not None else generator
            hard_ranks = self._hard_ranks(rect, draw, hard_noise, shard)
            rect2 = enforce_constraints(*hard_ranks, self.tables)
            out_ranks = RectifiedProbs(*(
                straight_through(h, l) for h, l in zip(rect2.ranks, self.tables.split(biased))
            ))
        else:
            out_ranks = rect
        masks = tuple((p > 0).to(logits.dtype) for p in out_ranks.ranks)
        valid = out_ranks.vertices.sum(dim=-1) > 0
        # Embeddings and masks from the output probs, operators from the
        # soft rectified probs (the same tensors when hard=False). Packed
        # ranks carry packed embeddings and masks; probs, rectified and the
        # losses stay in the full layout.
        ops = self.operators(rect, masks)
        embeddings = self.embed(out_ranks, ops.idx)
        if stretch is not None:
            beta, gamma, zeta = stretch
            l0 = hard_concrete_l0_penalty(biased, beta, HardConcreteParams(gamma, zeta)).mean(dim=-1)
        elif self.sampler == "hard_concrete":
            l0 = hard_concrete_l0_penalty(biased, temperature).mean(dim=-1)
        else:
            l0 = torch.zeros(logits.shape[:-1], dtype=logits.dtype, device=logits.device)
        return EncoderOutput(
            logits=logits,
            embeddings=embeddings,
            ops=ops,
            probs=out_ranks,
            rectified=rect,
            masks=ops.masks,
            valid=valid,
            l0=l0,
        )

    def forward(
        self,
        bands: torch.Tensor,
        temperature=1.0,
        train: bool = False,
        generator: torch.Generator | None = None,
        noise: torch.Tensor | None = None,
        hard_noise=None,
    ) -> EncoderOutput:
        logits = self.compute_logits(bands, train, generator)
        return self.generate_complex(logits, temperature, train, generator, noise, hard_noise)


def info_nce_loss(logits: torch.Tensor, temperature: float = 0.1) -> torch.Tensor:
    """InfoNCE over simplex-logit rows. logits: [B, G, S], row 0 = anchor,
    1 = positive, 2: = negatives; cross-entropy with label 0."""
    norm = logits / (torch.linalg.vector_norm(logits, dim=-1, keepdim=True) + 1e-12)
    anchor, positive, negatives = norm[:, 0], norm[:, 1], norm[:, 2:]
    pos = torch.einsum("bs,bs->b", anchor, positive)[:, None]  # [B, 1]
    neg = torch.einsum("bs,bks->bk", anchor, negatives)  # [B, K]
    scores = torch.cat([pos, neg], dim=1) / temperature
    return (torch.logsumexp(scores, dim=1) - scores[:, 0]).mean()


def triplet_loss(logits: torch.Tensor, margin: float = 1.0) -> torch.Tensor:
    """Triplet margin loss with L2 distance over [B, 3, S] logit rows."""
    anchor, positive, negative = logits[:, 0], logits[:, 1], logits[:, 2]
    d_pos = torch.linalg.vector_norm(anchor - positive, dim=-1)
    d_neg = torch.linalg.vector_norm(anchor - negative, dim=-1)
    return F.relu(d_pos - d_neg + margin).mean()


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
