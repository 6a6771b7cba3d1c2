"""Static-capacity packed operators: top-K active slicing at fixed shapes.

Port of ``topo_audio_autoencoder_tpu.topology.packed``. Each packed rank
keeps a fixed capacity of K rows, the top-K simplices by (mask +
probability), so that every incidence product of that rank runs over K
packed rows instead of all C(n, k); ranks below the packing boundary keep
the dense factored products of ``topology.builder``, whose memberships are
built only for them (at n=32 the packed ranks' e2t and t2tt, 10 and 713 MB
in fp32, are never built).

Face structure travels as per-sample index tables ([..., K_r, r+1] face ids
in the lower rank's layout): ``down`` products gather and sum the faces,
``up`` products scatter back through a 0/1 matrix. If every rank's capacity
covers its active rows, the packed forward equals the dense masked-static
one: rectification makes every face of an active simplex active, and the
mask term sorts every active row before every inactive one. Over capacity
the lowest-probability rows are dropped.

Spans (``utils.profiling``), each with its CUDA event pair and none inside
another: ``taa.packed.select`` (``build_packed_operators``: top-K, position
remapping, one-hot scatter), ``taa.packed.gather`` (``_gather_faces``),
``taa.packed.gather_bwd`` (``_FaceSum``'s backward) and
``taa.packed.scatter`` (``_scatter_faces``; the product's backward, which
autograd issues, lies outside every span). The counter ``packed.builds``
counts the operator sets built, profiled or not, as
``optimizer.fused_updates`` counts the updates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.profiling import count, span
from .builder import membership_matrix
from .complexes import ComplexTables
from .rectifier import RectifiedProbs, face_indices


class PackedOperators(NamedTuple):
    """Duck type of ``builder.SimplicialOperators`` with per-rank
    static-capacity packing.

    - ``probs`` / ``masks``: per rank; packed ranks are [..., K_r] in
      key-descending order, dense ranks the full [..., S_r].
    - ``idx``: per rank, the top-K indices into the full rank
      ([..., K_r]), or None for a dense rank.
    - ``faces``: per packed rank r >= 1, [..., K_r, r+1] face ids of each
      packed simplex in the lower rank's layout: packed positions, with the
      sentinel K_{r-1} for a face dropped from the lower rank's capacity,
      or full ids when the lower rank is dense.
    - ``face_onehots``: per packed rank r >= 1, [..., lower, K_r] with a 1
      where a lower row is a face of a packed simplex (sentinel faces
      dropped): ``_scatter_faces`` is a product with it.
    - ``memberships``: the dense membership of each rank pair that stays
      dense (entry i serves rank i+1), None once packing starts.
    """

    probs: tuple
    masks: tuple
    idx: tuple
    faces: tuple
    face_onehots: tuple
    memberships: tuple

    def is_packed(self, rank: int) -> bool:
        return self.idx[rank] is not None

    def _gather_faces(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        """``M_rank @ x`` over packed rows: the sum of x over each packed
        simplex's faces. x: [..., lower, C] -> [..., K_rank, C]."""
        with span("taa.packed.gather", device=True):
            return _FaceSum.apply(x, self.faces[rank], self.face_onehots[rank], self.is_packed(rank - 1))

    def _scatter_faces(self, rank: int, u: torch.Tensor) -> torch.Tensor:
        """``M_rank^T @ u`` over packed rows: each packed simplex's value
        added into its faces. u: [..., K_rank, C] -> [..., lower, C].

        A product with the 0/1 matrix ``face_onehots[rank]`` (built once per
        operator set), not ``index_add_``/``scatter_add_``: those add with
        atomics on the card, so their fp32 order of summation, and the
        result's last bits, would change from run to run. The product sums
        in a fixed order, and it is small (lower x K_rank per sample)."""
        with span("taa.packed.scatter", device=True):
            return self.face_onehots[rank] @ u

    # Products with the semantics of SimplicialOperators' (topology.builder).

    def up(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        p = self.probs[rank]
        if not self.is_packed(rank):
            return self.memberships[rank - 1].transpose(0, 1) @ (p[..., None] * x)
        return self._scatter_faces(rank, p[..., None] * x)

    def down(self, rank: int, x: torch.Tensor) -> torch.Tensor:
        p = self.probs[rank]
        if not self.is_packed(rank):
            return p[..., None] * (self.memberships[rank - 1] @ x)
        return p[..., None] * self._gather_faces(rank, x)

    def adj0_matmul(self, x: torch.Tensor) -> torch.Tensor:
        p = self.probs[1]
        if not self.is_packed(1):
            m = self.memberships[0]
            y = m.transpose(0, 1) @ (p[..., None] * (m @ x))
            deg = p @ m
            return y - deg[..., None] * x
        y = self._scatter_faces(1, p[..., None] * self._gather_faces(1, x))
        deg = self._scatter_faces(1, p[..., :, None])[..., 0]
        return y - deg[..., None] * x

    def gram_diag(self, rank: int, via_upper: bool) -> torch.Tensor:
        if via_upper:
            p = self.probs[rank + 1]
            if not self.is_packed(rank + 1):
                return (p * p) @ self.memberships[rank]
            return self._scatter_faces(rank + 1, (p * p)[..., :, None])[..., 0]
        p = self.probs[rank]
        return (p * p) * float(rank + 1)


def face_sum(x: torch.Tensor, faces: torch.Tensor, sentinel: bool) -> torch.Tensor:
    """The sum of x over each packed simplex's faces, by gather:
    x [..., lower, C], faces [..., K, F] -> [..., K, C]. With ``sentinel``
    the id ``lower`` names a face dropped from the lower rank's capacity,
    which gathers a zero row."""
    if sentinel:
        x = torch.cat([x, x.new_zeros((*x.shape[:-2], 1, x.shape[-1]))], dim=-2)
    flat = faces.reshape(*faces.shape[:-2], -1, 1)  # [..., K*F, 1]
    g = torch.take_along_dim(x, flat, dim=-2)  # [..., K*F, C]
    return g.reshape(*faces.shape, x.shape[-1]).sum(dim=-2)


class _FaceSum(torch.autograd.Function):
    """``face_sum`` forward; the backward is its adjoint ``M^T g``, the
    product with the 0/1 matrix ``onehot`` [..., lower, K] (sentinel faces
    dropped), as ``_scatter_faces`` computes it: autograd's own backward of
    the gather adds a face shared by several packed simplices with atomics
    on the card, in an order that changes from run to run, and the step
    would not repeat its gradients bit for bit. Under ``torch.func.vmap``
    the vmapped axis becomes one more leading axis of every input."""

    @staticmethod
    def forward(x, faces, onehot, sentinel):
        return face_sum(x, faces, sentinel)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2])

    @staticmethod
    def vmap(info, in_dims, x, faces, onehot, sentinel):
        k = info.batch_size
        x, faces, onehot = (t.movedim(d, 0) if d is not None else t.expand(k, *t.shape)
                            for t, d in zip((x, faces, onehot), in_dims[:3]))
        return _FaceSum.apply(x, faces, onehot, sentinel), 0

    @staticmethod
    def backward(ctx, g):
        (onehot,) = ctx.saved_tensors
        with span("taa.packed.gather_bwd", device=True):
            return onehot.to(g.dtype) @ g, None, None, None


def build_packed_operators(
    probs: RectifiedProbs,
    tables: ComplexTables,
    capacities,
    masks: tuple | None = None,
    select_key: tuple | None = None,
) -> PackedOperators:
    """Pack the top-K rows of each capacity-limited rank.

    ``capacities``: per-rank (len 4) ints, clipped to the rank's size; None
    or 0 keeps the rank dense. They must be upward-closed (packing rank r
    requires packing every rank above it), so the packing boundary is one
    rank r0 with every rank >= r0 packed.

    ``select_key`` (default ``mask + prob`` per rank) orders rows for the
    top-K (``torch.topk``: sorted, descending, as ``jax.lax.top_k``).
    Adding the {0,1} mask sorts every active row before every inactive one,
    so the packed set is the active set whenever capacity allows; the order
    among equal keys is unspecified, and nothing that reaches an output
    depends on it.
    """
    count("packed.builds")
    with span("taa.packed.select", device=True):
        dt = probs.edges.dtype
        device = probs.edges.device
        ranks = tuple(probs.ranks)
        if masks is None:
            masks = tuple((p > 0).to(dt) for p in ranks)
        caps = [None if not c else min(int(c), s) for c, s in zip(capacities, tables.sizes)]
        for r in range(3):
            if caps[r] is not None and caps[r + 1] is None:
                raise ValueError(
                    f"capacities must be upward-closed: rank {r} is packed "
                    f"but rank {r + 1} is dense ({capacities!r})"
                )
        face_tables = (None, *face_indices(tables, device))  # edges, tri_edges, tet_tris
        idx, faces, onehots = [None] * 4, [None] * 4, [None] * 4
        pprobs, pmasks = list(ranks), list(masks)
        for r in range(4):
            if caps[r] is None:
                continue
            key = select_key[r] if select_key is not None else masks[r] + ranks[r]
            ix = torch.topk(key, caps[r], dim=-1).indices  # [..., K], key-descending
            idx[r] = ix
            pprobs[r] = torch.gather(ranks[r], -1, ix)
            pmasks[r] = torch.gather(masks[r], -1, ix)
            if r == 0:
                continue
            f = face_tables[r][ix]  # [..., K, r+1] full lower ids
            lower = tables.sizes[r - 1]
            if idx[r - 1] is not None:
                # Full lower ids -> packed positions; a row dropped from the
                # lower rank's capacity maps to the sentinel K_lower.
                kl = caps[r - 1]
                pos = torch.full((*ix.shape[:-1], lower), kl, dtype=torch.long, device=device)
                pos.scatter_(-1, idx[r - 1], torch.arange(kl, device=device).expand_as(idx[r - 1]))
                f = torch.gather(pos, -1, f.reshape(*f.shape[:-2], -1)).reshape(f.shape)
                lower = kl
            faces[r] = f
            onehot = torch.zeros((*ix.shape[:-1], lower + 1, caps[r]), dtype=dt, device=device)
            onehot.scatter_(-2, f.transpose(-1, -2), 1.0)
            onehots[r] = onehot[..., :lower, :]  # the sentinel row dropped
        memberships = tuple(
            membership_matrix(tables, r, dt, device) if caps[r] is None else None for r in (1, 2, 3)
        )
        return PackedOperators(
            probs=tuple(pprobs),
            masks=tuple(pmasks),
            idx=tuple(idx),
            faces=tuple(faces),
            face_onehots=tuple(onehots),
            memberships=memberships,
        )
