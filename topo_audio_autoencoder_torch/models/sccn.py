"""Simplicial Complex Convolutional Network (SCCN), masked-static & batched.

Port of ``GradientSCCNLayer`` / ``GradientSCCN`` in
``topo_audio_autoencoder_tpu.models.sccn`` over the full hierarchy (ranks
0..3). Per rank r a layer computes up to three message carriers,

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
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.sccn_combine import MIN_FUSED_ROWS, fused_message_combine, message_combine_reference
from ..topology.builder import SimplicialOperators
from .encoder import layer_norm
from .init import lecun_normal_

MAX_RANK = 3


class GradientSCCNLayer(nn.Module):
    """One masked-static SCCN layer over ranks 0..3."""

    def __init__(self, channels: int, is_final_layer: bool = False, fused_combine: bool = False):
        super().__init__()
        c = channels
        self.channels = c
        self.is_final_layer = is_final_layer
        self.fused_combine = fused_combine
        # Per-message-type scales, shared across ranks.
        self.scale_same = nn.Parameter(torch.ones(1))
        self.scale_low_to_high = nn.Parameter(torch.ones(1))
        self.scale_high_to_low = nn.Parameter(torch.ones(1))
        for rank in range(MAX_RANK + 1):
            self.register_parameter(f"same_rank_{rank}", nn.Parameter(torch.empty(c, c)))
            if rank < MAX_RANK:
                self.register_parameter(f"high_to_low_{rank}", nn.Parameter(torch.empty(c, c)))
            if rank > 0:
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
        down = {r: ops.down(r, features[r - 1]) for r in range(1, MAX_RANK + 1)}
        up = {r: ops.up(r, features[r]) for r in range(1, MAX_RANK + 1)}

        out = []
        for rank in range(MAX_RANK + 1):
            x = features[rank]
            if rank == 0:
                car = ops.adj0_matmul(x)
            elif rank < MAX_RANK:
                # A_r = B_{r+1} B_{r+1}^T - D: reuse down_{r+1}.
                core = ops.up(rank + 1, down[rank + 1])
                car = core - ops.gram_diag(rank, via_upper=True)[..., :, None] * x
            else:
                # A_top = B_top^T B_top - D: reuse up_top.
                core = ops.down(rank, up[rank])
                car = core - ops.gram_diag(rank, via_upper=False)[..., :, None] * x
            mixes = [(getattr(self, f"same_rank_{rank}"), self.scale_same, car)]
            if rank < MAX_RANK:
                mixes.append(
                    (getattr(self, f"high_to_low_{rank}"), self.scale_high_to_low, up[rank + 1])
                )
            if rank > 0:
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

    def __init__(self, channels: int, n_layers: int = 6):
        super().__init__()
        self.n_layers = n_layers
        for i in range(n_layers):
            self.add_module(
                f"layer_{i}", GradientSCCNLayer(channels, is_final_layer=(i == n_layers - 1))
            )

    def reset_parameters(self, generator: torch.Generator) -> None:
        for i in range(self.n_layers):
            getattr(self, f"layer_{i}").reset_parameters(generator)

    def forward(self, features, ops: SimplicialOperators, train: bool = False):
        for i in range(self.n_layers):
            features = getattr(self, f"layer_{i}")(features, ops, train)
        return list(features)
