"""Simplicial-closure rectification of per-simplex probabilities.

Port of ``topo_audio_autoencoder_tpu.topology.rectifier``, with both
contractions (``method``: the face gather by default, or the product with
the dense memberships).
Rank by rank, bottom-up:

1. a simplex with any zero-probability face gets probability exactly 0, and
2. a simplex is never more probable than the geometric mean of its faces:
   ``rectified = min(raw, exp(mean(log(face_probs + eps))))``.

The zero masks chain like the reference: edges mask from the raw vertex
probs, triangles from the rectified edges, tetra from the rectified
triangles. The log/exp chain with eps=1e-10 underflows in bf16, so the
rectifier always computes in float32 and casts back to the input dtype.

The face gather's backward adds each face's cotangents in a fixed order
(``_FaceGather``): autograd's own backward of an index adds them with
atomics on the card, in an order that changes from run to run, and a
train step would not repeat its gradients bit for bit.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from .complexes import ComplexTables


class RectifiedProbs(NamedTuple):
    """Per-rank rectified probabilities [..., S_r]."""

    vertices: torch.Tensor
    edges: torch.Tensor
    triangles: torch.Tensor
    tetra: torch.Tensor

    @property
    def all_simplices(self) -> torch.Tensor:
        return torch.cat(list(self.ranks), dim=-1)

    @property
    def ranks(self):
        return (self.vertices, self.edges, self.triangles, self.tetra)


@lru_cache(maxsize=16)
def face_indices(tables: ComplexTables, device: torch.device) -> tuple:
    """The static face tables (edges, tri_edges, tet_tris) as long tensors
    on ``device``, built once per (tables, device), with inference mode off
    (see ``builder.membership_matrices``)."""
    with torch.inference_mode(False):
        return tuple(
            torch.as_tensor(idx, dtype=torch.long, device=device)
            for idx in (tables.edges, tables.tri_edges, tables.tet_tris)
        )


def index_adjoint(idx: np.ndarray, n: int) -> np.ndarray:
    """For each of ``n`` targets, the flat positions of ``idx`` (any shape;
    for a face table [S, k], ``s * k + j``) that name it, ascending:
    [n, c] with c the most any target has; a target with fewer is padded
    with ``idx.size``."""
    flat = np.asarray(idx, dtype=np.int64).reshape(-1)
    counts = np.bincount(flat, minlength=n)
    order = np.argsort(flat, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    adjoint = np.full((n, int(counts.max(initial=0))), flat.size, np.int64)
    adjoint[flat[order], np.arange(flat.size) - starts[flat[order]]] = order
    return adjoint


@lru_cache(maxsize=16)
def face_adjoints(tables: ComplexTables, device: torch.device) -> tuple:
    """``index_adjoint`` of each face table of ``face_indices``, on
    ``device``, built once per (tables, device)."""
    with torch.inference_mode(False):
        return tuple(
            torch.as_tensor(index_adjoint(idx, tables.sizes[r]), device=device)
            for r, idx in enumerate((tables.edges, tables.tri_edges, tables.tet_tris))
        )


class _FaceGather(torch.autograd.Function):
    """``x[..., face_idx]``: [..., F] -> [..., S, k]. The backward sums each
    face's cotangents over its ``adjoint`` positions in their fixed order.
    Under ``torch.func.vmap`` the vmapped axis becomes one more leading
    axis of ``x`` (one call for all K)."""

    @staticmethod
    def forward(x, face_idx, adjoint):
        return x[..., face_idx]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2])

    @staticmethod
    def vmap(info, in_dims, x, face_idx, adjoint):
        if any(d is not None for d in in_dims[1:]):
            raise ValueError("the face gather: only x may be vmapped, not the face tables")
        return _FaceGather.apply(x.movedim(in_dims[0], 0), face_idx, adjoint), 0

    @staticmethod
    def backward(ctx, g):
        (adjoint,) = ctx.saved_tensors
        flat = g.reshape(*g.shape[:-2], -1)
        flat = torch.cat([flat, flat.new_zeros(*flat.shape[:-1], 1)], dim=-1)  # the pad position
        return flat[..., adjoint].sum(dim=-1), None, None


def _rectify_rank(
    raw: torch.Tensor, face_probs: torch.Tensor, face_idx: torch.Tensor, adjoint: torch.Tensor, eps: float
) -> torch.Tensor:
    """min(raw, geomean of the k faces), zeros propagated (gather form)."""
    log_faces = torch.log(face_probs + eps)
    geo = torch.exp(_FaceGather.apply(log_faces, face_idx, adjoint).mean(dim=-1))  # [..., S]
    zero = (face_probs == 0.0)[..., face_idx].any(dim=-1)
    geo = torch.where(zero, torch.zeros_like(geo), geo)
    return torch.minimum(raw, geo)


def _rectify_rank_matmul(raw: torch.Tensor, face_probs: torch.Tensor, membership_t: torch.Tensor, k: float,
                         eps: float) -> torch.Tensor:
    """The same rectification as a product with the transposed dense
    membership [F, S]: ``log(face + eps) @ membership_t / k``, and a zero
    face found by ``(face == 0) @ membership_t > 0``."""
    geo = torch.exp(torch.log(face_probs + eps) @ membership_t / k)
    zero = (face_probs == 0.0).to(membership_t.dtype) @ membership_t
    geo = torch.where(zero > 0.0, torch.zeros_like(geo), geo)
    return torch.minimum(raw, geo)


# The contraction of the face geometric means: "gather" reads the k face
# values of each simplex through the static face tables; "matmul" is a
# product with the dense membership matrices (tables.v2e/e2t/t2tt, built
# once per device; t2tt is [S_3, S_2], 99.65% zeros at n=20 and 713 MB in
# fp32 at n=32). The same function either way, summed in other orders.
DEFAULT_METHOD = "gather"


def enforce_constraints(
    vertex_probs: torch.Tensor,
    edge_probs: torch.Tensor,
    triangle_probs: torch.Tensor,
    tetra_probs: torch.Tensor,
    tables: ComplexTables,
    eps: float = 1e-10,
    method: str | None = None,
) -> RectifiedProbs:
    """Rectify probabilities bottom-up so they form a valid (soft) complex.

    Accepts arbitrary leading batch dims. Vertices pass through unrectified.
    ``method``: "gather" or "matmul" (default ``DEFAULT_METHOD``).
    """
    method = method or DEFAULT_METHOD
    in_dtype = vertex_probs.dtype
    v, e, t, tt = (
        p.to(torch.float32) for p in (vertex_probs, edge_probs, triangle_probs, tetra_probs)
    )
    if method == "gather":
        edges, tri_edges, tet_tris = face_indices(tables, v.device)
        a_edges, a_tri_edges, a_tet_tris = face_adjoints(tables, v.device)
        re = _rectify_rank(e, v, edges, a_edges, eps)
        rt = _rectify_rank(t, re, tri_edges, a_tri_edges, eps)
        rtt = _rectify_rank(tt, rt, tet_tris, a_tet_tris, eps)
    elif method == "matmul":
        from .builder import membership_matrices

        v2e, e2t, t2tt = (m.transpose(0, 1) for m in membership_matrices(tables, torch.float32, v.device))
        re = _rectify_rank_matmul(e, v, v2e, 2.0, eps)
        rt = _rectify_rank_matmul(t, re, e2t, 3.0, eps)
        rtt = _rectify_rank_matmul(tt, rt, t2tt, 4.0, eps)
    else:
        raise ValueError(f"method must be 'matmul' or 'gather', got {method!r}")
    return RectifiedProbs(*(p.to(in_dtype) for p in (v, re, rt, rtt)))


def enforce_constraints_flat(
    all_probs: torch.Tensor, tables: ComplexTables, eps: float = 1e-10
) -> RectifiedProbs:
    """Rectify a flat [..., total_simplices] probability vector."""
    return enforce_constraints(*tables.split(all_probs), tables, eps)


def constraint_violations(probs: RectifiedProbs, tables: ComplexTables) -> dict:
    """Max violation of each closure property; all ~0 for rectified probs."""
    eps = 1e-10

    def check(rect, faces, membership, k):
        m = torch.as_tensor(membership.T, dtype=torch.float32, device=faces.device)
        faces = faces.to(torch.float32)
        geo = torch.exp(torch.log(faces + eps) @ m / k)
        zero = (faces == 0.0).to(torch.float32) @ m
        geo = torch.where(zero > 0, torch.zeros_like(geo), geo)
        rect = rect.to(torch.float32)
        over = torch.clamp(rect - geo, min=0.0)
        zero_violation = torch.where(zero > 0, rect.abs(), torch.zeros_like(rect))
        return float(over.max()), float(zero_violation.max())

    e_over, e_zero = check(probs.edges, probs.vertices, tables.v2e, 2.0)
    t_over, t_zero = check(probs.triangles, probs.edges, tables.e2t, 3.0)
    tt_over, tt_zero = check(probs.tetra, probs.triangles, tables.t2tt, 4.0)
    return {
        "edge_over_geomean": e_over,
        "edge_zero_face": e_zero,
        "triangle_over_geomean": t_over,
        "triangle_zero_face": t_zero,
        "tetra_over_geomean": tt_over,
        "tetra_zero_face": tt_zero,
    }
