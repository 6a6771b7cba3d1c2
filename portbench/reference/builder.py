"""Factored simplicial message-passing operators from rectified probs.

No per-sample
operator matrix is ever materialized: every operator factors through a
static 0/1 membership matrix and the per-sample probability vector,

    inc_r  @ X     = M_r^T @ (p_r * X)        ("up"   product)
    inc_r^T @ X    = p_r * (M_r @ X)          ("down" product)
    A_0    @ X     = M_1^T @ (p_1 * (M_1 @ X)) - deg * X

where M_r is the [S_r, S_{r-1}] face membership of rank r and p_r the
rectified probabilities.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .complexes import ComplexTables
from .rectifier import RectifiedProbs


class SimplicialOperators(NamedTuple):
    """Factored, fixed-shape operator set for the SCCN.

    - ``probs``: per-rank rectified probabilities [..., S_r].
    - ``masks``: per-rank {0,1} active masks [..., S_r].
    - ``memberships``: static v2e [E, V], e2t [T, E], t2tt [Tt, T].
    """

    probs: tuple
    masks: tuple
    memberships: tuple

    @property
    def idx(self) -> tuple:
        """Per-rank packed-row indices, as ``PackedOperators.idx``: every
        rank is dense here."""
        return (None,) * 4

    def up(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """``inc_rank @ x``: [..., S_rank, C] -> [..., S_{rank-1}, C]."""
        m = self.memberships[rank - 1]  # [S_r, S_{r-1}]
        p = self.probs[rank]
        return m.transpose(0, 1) @ (p[..., None] * x)

    def down(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """``inc_rank^T @ x``: [..., S_{rank-1}, C] -> [..., S_rank, C]."""
        m = self.memberships[rank - 1]
        p = self.probs[rank]
        return p[..., None] * (m @ x)

    def adj0_matmul(self, x: torch.Tensor) -> torch.Tensor:
        """``A_0 @ x``: vertex adjacency weighted by edge probs, degree
        diagonal removed."""
        m = self.memberships[0]  # v2e [E, V]
        p = self.probs[1]
        y = m.transpose(0, 1) @ (p[..., None] * (m @ x))
        deg = p @ m  # [..., V] weighted vertex degree
        return y - deg[..., None] * x

    def gram_diag(self, rank: int, via_upper: bool) -> torch.Tensor:
        """Diagonal of the rank-``rank`` incidence Gram."""
        if via_upper:
            p = self.probs[rank + 1]
            return (p * p) @ self.memberships[rank]  # [..., S_rank]
        p = self.probs[rank]
        return (p * p) * float(rank + 1)


def membership_matrix(tables: ComplexTables, rank: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The dense [S_rank, S_{rank-1}] membership of rank ``rank`` (1..3)."""
    return torch.as_tensor(tables.membership(rank), dtype=dtype, device=device)


def build_operators(
    probs: RectifiedProbs, tables: ComplexTables, masks: tuple | None = None
) -> SimplicialOperators:
    """Build the factored operator set. Batched over leading dims.

    ``masks`` defaults to ``prob > 0`` per rank.
    """
    dt = probs.edges.dtype
    memberships = tuple(membership_matrix(tables, r, dt, probs.edges.device) for r in (1, 2, 3))
    if masks is None:
        masks = tuple((p > 0).to(dt) for p in probs.ranks)
    return SimplicialOperators(
        probs=tuple(probs.ranks), masks=tuple(masks), memberships=memberships
    )
