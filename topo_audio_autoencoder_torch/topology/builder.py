"""Factored simplicial message-passing operators from rectified probs.

Port of ``topo_audio_autoencoder_tpu.topology.builder``. No per-sample
operator matrix is ever materialized: every operator factors through a
static 0/1 membership matrix and the per-sample probability vector,

    inc_r  @ X     = M_r^T @ (p_r * X)        ("up"   product)
    inc_r^T @ X    = p_r * (M_r @ X)          ("down" product)
    A_0    @ X     = M_1^T @ (p_1 * (M_1 @ X)) - deg * X

where M_r is the [S_r, S_{r-1}] face membership of rank r and p_r the
rectified probabilities. Each dense membership is built once per
(tables, rank, dtype, device), and only when a product asks for it: at
n=20 the largest, t2tt, is [4845, 1140] (22 MB in fp32), at n=32
[35960, 4960] (713 MB), which the packed operators (``topology.packed``)
never build.

``adj0`` / ``inc1..3`` / ``adj_diag`` and ``dense_adjacency`` materialize
the operators for tests and inspection.
"""

from __future__ import annotations

from collections import OrderedDict
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

    # --------------------------------------------------- materializers

    @property
    def adj0(self) -> torch.Tensor:
        m = self.memberships[0]
        p = self.probs[1]
        gram0 = torch.einsum("...ev,...eu->...vu", p[..., :, None] * m, m)
        return gram0 * (1.0 - torch.eye(m.shape[-1], dtype=m.dtype, device=m.device))

    def incidence(self, rank: int) -> torch.Tensor:
        """Materialized ``inc_rank = M_rank^T * p_rank`` (tests only)."""
        m = self.memberships[rank - 1]
        p = self.probs[rank]
        return (m * p[..., :, None]).transpose(-1, -2)

    @property
    def inc1(self) -> torch.Tensor:
        return self.incidence(1)

    @property
    def inc2(self) -> torch.Tensor:
        return self.incidence(2)

    @property
    def inc3(self) -> torch.Tensor:
        return self.incidence(3)

    @property
    def adj_diag(self) -> tuple:
        """Gram diagonals (d1 [E], d2 [T], d3 [Tt]): ranks 1-2 via shared
        cofaces, the top rank via shared faces."""
        return (
            self.gram_diag(1, via_upper=True),
            self.gram_diag(2, via_upper=True),
            self.gram_diag(3, via_upper=False),
        )


# The dense memberships built so far, keyed by (n, sizes, rank, dtype,
# device): tables with the same n and sizes hold the same matrices. The
# least recently used one goes beyond _MAX_MEMBERSHIPS.
_memberships: OrderedDict = OrderedDict()
_MAX_MEMBERSHIPS = 48


def membership_matrix(
    tables: ComplexTables, rank: int, dtype: torch.dtype, device: torch.device
) -> torch.Tensor:
    """The dense [S_rank, S_{rank-1}] membership of rank ``rank`` (1..3),
    built once per (tables, rank, dtype, device).

    Built with inference mode off, so that a first call under
    ``torch.inference_mode`` (the codec) does not cache a tensor that a
    later training step could not save for backward."""
    key = (tables.n, tables.sizes, rank, dtype, torch.device(device))
    if key in _memberships:
        _memberships.move_to_end(key)
    else:
        with torch.inference_mode(False):
            _memberships[key] = torch.as_tensor(tables.membership(rank), dtype=dtype, device=device)
        if len(_memberships) > _MAX_MEMBERSHIPS:
            _memberships.popitem(last=False)
    return _memberships[key]


def built_memberships(n: int) -> list:
    """The dense memberships held for complexes on ``n`` vertices, as
    sorted (rank, device name) pairs."""
    return sorted({(key[2], str(key[4])) for key in _memberships if key[0] == n})


def membership_matrices(
    tables: ComplexTables, dtype: torch.dtype, device: torch.device
) -> tuple:
    """v2e, e2t, t2tt as dense tensors (``membership_matrix`` of ranks 1-3)."""
    return tuple(membership_matrix(tables, r, dtype, device) for r in (1, 2, 3))


def build_operators(
    probs: RectifiedProbs, tables: ComplexTables, masks: tuple | None = None
) -> SimplicialOperators:
    """Build the factored operator set. Batched over leading dims.

    ``masks`` defaults to ``prob > 0`` per rank.
    """
    dt = probs.edges.dtype
    memberships = membership_matrices(tables, dt, probs.edges.device)
    if masks is None:
        masks = tuple((p > 0).to(dt) for p in probs.ranks)
    return SimplicialOperators(
        probs=tuple(probs.ranks), masks=tuple(masks), memberships=memberships
    )


def same_rank_matmul(ops: SimplicialOperators, rank: int, x: torch.Tensor) -> torch.Tensor:
    """``A_rank @ x`` without materializing A. x: [..., S_rank, C].

    The convention is fixed whatever the truncation: ranks 1-2 connect via
    shared cofaces, rank 3 via shared faces; a statically empty coface rank
    gives A == 0 (the zero-size Gram product is zeros)."""
    if rank == 0:
        return ops.adj0_matmul(x)
    if not 1 <= rank <= 3:
        raise ValueError(f"rank must be in 0..3, got {rank}")
    if rank < 3:
        # A_r = inc_{r+1} @ inc_{r+1}^T - D
        p = ops.probs[rank + 1]
        m = ops.memberships[rank]  # [S_{r+1}, S_r]
        gram_x = m.transpose(0, 1) @ ((p * p)[..., None] * (m @ x))
        return gram_x - ops.gram_diag(rank, via_upper=True)[..., None] * x
    # A_3 = inc_3^T @ inc_3 - D
    p = ops.probs[rank]
    m = ops.memberships[rank - 1]  # [S_r, S_{r-1}]
    gram_x = p[..., None] * (m @ (m.transpose(0, 1) @ (p[..., None] * x)))
    return gram_x - ops.gram_diag(rank, via_upper=False)[..., None] * x


def dense_adjacency(ops: SimplicialOperators, rank: int) -> torch.Tensor:
    """The dense adjacency of a rank (tests and inspection only), in the
    conventions of ``same_rank_matmul``."""
    if rank == 0:
        return ops.adj0
    if rank == 1:
        inc, d = ops.inc2, ops.adj_diag[0]
    elif rank == 2:
        inc, d = ops.inc3, ops.adj_diag[1]
    elif rank == 3:
        inc, d = ops.inc3.transpose(-1, -2), ops.adj_diag[2]
    else:
        raise ValueError(f"rank must be in 0..3, got {rank}")
    gram = inc @ inc.transpose(-1, -2)
    eye = torch.eye(gram.shape[-1], dtype=gram.dtype, device=gram.device)
    return gram - d[..., :, None] * eye
