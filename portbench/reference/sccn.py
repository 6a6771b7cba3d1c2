"""Simplicial Complex Convolutional Network (SCCN), masked-static & batched.

One layer, per rank r, computes up to three message carriers,

- same-rank:     ``A_r @ X_r``
- high-to-low:   ``B_{r+1} @ X_{r+1}``
- low-to-high:   ``B_r^T @ X_{r-1}``

each mixed by its own raw ``[C, C]`` weight (right-multiplied) times a
learnable scale, given the residual ``+ X_r``, and combined by a softmax
over the message axis (``combine``). Every neighborhood product goes
through the factored operators; the down/up products are computed once per
layer and shared. LayerNorm is applied only in training and never on the
final layer, which owns no norm parameters.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from .builder import SimplicialOperators
from .combine import message_combine
from .encoder import layer_norm

MAX_RANK = 3


class GradientSCCNLayer(nn.Module):
    """One masked-static SCCN layer over ranks 0..3. ``sizes``: the rank
    sizes (default: every rank present)."""

    def __init__(
        self,
        channels: int,
        is_final_layer: bool = False,
        sizes: Sequence[int] | None = None,
    ):
        super().__init__()
        c = channels
        self.channels = c
        self.is_final_layer = is_final_layer
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
            y = message_combine(
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

    def forward(self, features, ops: SimplicialOperators, train: bool = False):
        for i in range(self.n_layers):
            features = getattr(self, f"layer_{i}")(features, ops, train)
        return list(features)
