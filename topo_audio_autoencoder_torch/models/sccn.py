"""Simplicial Complex Convolutional Network (SCCN), masked-static & batched.

Port of ``GradientSCCNLayer`` / ``GradientSCCN`` / ``JumpingKnowledgeSCCN``
in ``topo_audio_autoencoder_tpu.models.sccn`` over ranks 0..3. Per rank r a
layer computes up to three message carriers,

- same-rank:     ``A_r @ X_r``
- high-to-low:   ``B_{r+1} @ X_{r+1}``
- low-to-high:   ``B_r^T @ X_{r-1}``

each mixed by its own raw ``[C, C]`` weight (right-multiplied, as in the JAX
package, not an ``nn.Linear``) times a learnable scale, given the residual
``+ X_r`` (every JAX caller keeps ``residual=True``), and combined by a
softmax over the message axis (``ops.sccn_combine``). Every neighborhood product goes through the
factored ``SimplicialOperators``; the down/up products are computed once
per layer and shared. LayerNorm is applied only in training and never on
the final layer, which owns no norm parameters.

``fused_combine`` mirrors the JAX layer's field: when set, every rank of at
least ``MIN_FUSED_ROWS`` rows (B * S_r) combines through
``fused_message_combine`` (the CUDA kernels on the card), the others
through ``message_combine_reference``. It is off by default, and
``GradientSCCN`` never sets it, as in the JAX package; a caller switches a
built layer with ``layer.fused_combine = True``.

Ranks that ``max_rank`` truncation leaves empty are told to a layer at
construction (``sizes``, the tables' rank sizes; the JAX layer reads them
off the shapes): an empty rank passes through, a carrier whose neighbour
rank is empty is zeros or absent, and neither owns a parameter, so the
parameter set is the flax tree's.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.sccn_combine import MIN_FUSED_ROWS, fused_message_combine, message_combine_reference
from ..topology.builder import SimplicialOperators
from .encoder import layer_norm
from .init import lecun_normal_, orthogonal_

MAX_RANK = 3


class GradientSCCNLayer(nn.Module):
    """One masked-static SCCN layer over ranks 0..3. ``sizes``: the rank
    sizes (default: every rank present)."""

    def __init__(
        self,
        channels: int,
        is_final_layer: bool = False,
        fused_combine: bool = False,
        sizes: Sequence[int] | None = None,
    ):
        super().__init__()
        c = channels
        self.channels = c
        self.is_final_layer = is_final_layer
        self.fused_combine = fused_combine
        present = tuple(s > 0 for s in sizes) if sizes is not None else (True,) * (MAX_RANK + 1)
        self.present = present
        # The incidence products between ranks r-1 and r exist when both do.
        self.linked = {r: present[r - 1] and present[r] for r in range(1, MAX_RANK + 1)}
        # Per-message-type scales, shared across ranks.
        self.scale_same = nn.Parameter(torch.ones(1))
        self.scale_low_to_high = nn.Parameter(torch.ones(1))
        self.scale_high_to_low = nn.Parameter(torch.ones(1))
        for rank in range(MAX_RANK + 1):
            if not present[rank]:
                continue
            self.register_parameter(f"same_rank_{rank}", nn.Parameter(torch.empty(c, c)))
            if rank < MAX_RANK and self.linked[rank + 1]:
                self.register_parameter(f"high_to_low_{rank}", nn.Parameter(torch.empty(c, c)))
            if rank > 0 and self.linked[rank]:
                self.register_parameter(f"low_to_high_{rank}", nn.Parameter(torch.empty(c, c)))
            self.register_parameter(f"attn_w1_{rank}", nn.Parameter(torch.empty(c, c)))
            self.register_parameter(f"attn_b1_{rank}", nn.Parameter(torch.empty(c)))
            self.register_parameter(f"attn_w2_{rank}", nn.Parameter(torch.empty(c, 1)))
            if not is_final_layer:
                self.add_module(f"norm_{rank}", layer_norm(c))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The layer's raw parameters; its LayerNorms are standard modules."""
        with torch.no_grad():
            for name, p in self.named_parameters(recurse=False):
                if name.startswith("scale_"):
                    p.fill_(1.0)
                elif name.startswith("attn_b1_"):
                    p.zero_()
                else:
                    lecun_normal_(p, p.shape[0], generator)

    def forward(
        self,
        features: Sequence[torch.Tensor],
        ops: SimplicialOperators,
        train: bool = False,
    ) -> list[torch.Tensor]:
        # Shared incidence products: down_r = B_r^T X_{r-1} [B, S_r, C] and
        # up_r = B_r X_r [B, S_{r-1}, C]. Channel mixing commutes with them.
        down = {r: ops.down(r, features[r - 1]) for r in range(1, MAX_RANK + 1) if self.linked[r]}
        up = {r: ops.up(r, features[r]) for r in range(1, MAX_RANK + 1) if self.linked[r]}

        out = []
        for rank in range(MAX_RANK + 1):
            x = features[rank]
            if not self.present[rank]:
                out.append(x)
                continue
            if rank == 0:
                car = ops.adj0_matmul(x)
            elif rank < MAX_RANK and rank + 1 in down:
                # A_r = B_{r+1} B_{r+1}^T - D: reuse down_{r+1}.
                core = ops.up(rank + 1, down[rank + 1])
                car = core - ops.gram_diag(rank, via_upper=True)[..., :, None] * x
            elif rank == MAX_RANK and rank in up:
                # A_top = B_top^T B_top - D: reuse up_top.
                core = ops.down(rank, up[rank])
                car = core - ops.gram_diag(rank, via_upper=False)[..., :, None] * x
            else:  # the neighbour rank is empty: A_r == 0
                car = torch.zeros_like(x)
            mixes = [(getattr(self, f"same_rank_{rank}"), self.scale_same, car)]
            if rank < MAX_RANK and rank + 1 in up:
                mixes.append(
                    (getattr(self, f"high_to_low_{rank}"), self.scale_high_to_low, up[rank + 1])
                )
            if rank > 0 and rank in down:
                mixes.append(
                    (getattr(self, f"low_to_high_{rank}"), self.scale_low_to_high, down[rank])
                )
            # Scales fold into the mix weights: V = W * scale.
            v = torch.stack([w * s for w, s, _ in mixes])  # [M, C, C]
            cars = tuple(cr for _, _, cr in mixes)
            combine = (
                fused_message_combine
                if self.fused_combine and x.shape[:-1].numel() >= MIN_FUSED_ROWS
                else message_combine_reference
            )
            y = combine(
                cars, x, v,
                getattr(self, f"attn_w1_{rank}"),
                getattr(self, f"attn_b1_{rank}"),
                getattr(self, f"attn_w2_{rank}"),
            )
            if train and not self.is_final_layer:
                y = getattr(self, f"norm_{rank}")(y)
            out.append(y)
        return out


class GradientSCCN(nn.Module):
    """Stack of ``n_layers`` GradientSCCNLayers."""

    def __init__(self, channels: int, n_layers: int = 6, sizes: Sequence[int] | None = None):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(
                f"layer_{i}",
                GradientSCCNLayer(channels, is_final_layer=(i == n_layers - 1), sizes=sizes),
            )

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.n_layers):
            getattr(self, f"layer_{i}").reset_parameters(generator)

    def forward(self, features, ops: SimplicialOperators, train: bool = False):
        for i in range(self.n_layers):
            features = getattr(self, f"layer_{i}")(features, ops, train)
        return list(features)


LSTM_GATES = ("i", "f", "g", "o")


class LSTMCell(nn.Module):
    """``flax.linen.OptimizedLSTMCell`` run over a whole sequence, with its
    parameter names: input kernels ``ii/if/ig/io`` without bias, hidden
    kernels ``hi/hf/hg/ho`` with one bias each (``nn.LSTM`` carries two
    biases per gate, which a flax tree cannot fill). Gates in the order
    i, f, g, o; ``c' = sigmoid(f) c + sigmoid(i) tanh(g)``,
    ``h' = sigmoid(o) tanh(c')``; the carry starts at zero."""

    def __init__(self, channels: int):
        super().__init__()
        self.channels = channels
        for g in LSTM_GATES:
            self.add_module(f"i{g}", nn.Linear(channels, channels, bias=False))
            self.add_module(f"h{g}", nn.Linear(channels, channels))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: lecun-normal input kernels, orthogonal hidden
        kernels, zero biases."""
        with torch.no_grad():
            for g in LSTM_GATES:
                lecun_normal_(getattr(self, f"i{g}").weight, self.channels, generator)
                orthogonal_(getattr(self, f"h{g}").weight, generator)
                getattr(self, f"h{g}").bias.zero_()

    def forward(self, seq: torch.Tensor) -> torch.Tensor:
        """[N, L, C] -> the hidden state after every step, [N, L, C]."""
        c = self.channels
        w_in = torch.cat([getattr(self, f"i{g}").weight for g in LSTM_GATES]).T  # [C, 4C]
        w_h = torch.cat([getattr(self, f"h{g}").weight for g in LSTM_GATES]).T  # [C, 4C]
        b_h = torch.cat([getattr(self, f"h{g}").bias for g in LSTM_GATES])  # [4C]
        x_in = seq @ w_in  # every step's input product at once: [N, L, 4C]
        h = seq.new_zeros(seq.shape[0], c)
        cell = seq.new_zeros(seq.shape[0], c)
        hs = []
        for t in range(seq.shape[1]):
            z = (h @ w_h + b_h) + x_in[:, t]
            i, f, g, o = z.split(c, dim=-1)
            cell = torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(cell)
            hs.append(h)
        return torch.stack(hs, dim=1)


class JumpingKnowledgeSCCN(GradientSCCN):
    """GradientSCCN's layers, then a 2-layer LSTM per simplex over the
    layers' outputs ([B * S_r, n_layers, C]), keeping the last step. The
    two cells are shared across ranks and carry the flax names
    ``OptimizedLSTMCell_0`` (the first LSTM) and ``OptimizedLSTMCell_1``."""

    def __init__(self, channels: int, n_layers: int = 2, sizes: Sequence[int] | None = None):
        super().__init__(channels, n_layers, sizes)
        self.OptimizedLSTMCell_0 = LSTMCell(channels)
        self.OptimizedLSTMCell_1 = LSTMCell(channels)

    def reset_parameters(self, generator: torch.Generator) -> None:
        super().reset_parameters(generator)
        self.OptimizedLSTMCell_0.reset_parameters(generator)
        self.OptimizedLSTMCell_1.reset_parameters(generator)

    def forward(self, features, ops: SimplicialOperators, train: bool = False):
        per_layer = []
        for i in range(self.n_layers):
            features = getattr(self, f"layer_{i}")(features, ops, train)
            per_layer.append(features)
        out = []
        for rank in range(MAX_RANK + 1):
            seq = torch.stack([f[rank] for f in per_layer], dim=-2)  # [B, S, L, C]
            b, s, l, c = seq.shape
            if s == 0:
                out.append(seq[:, :, 0, :])
                continue
            h = self.OptimizedLSTMCell_1(self.OptimizedLSTMCell_0(seq.reshape(b * s, l, c)))
            out.append(h[:, -1, :].reshape(b, s, c))
        return out
