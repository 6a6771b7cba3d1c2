"""Simplicial-closure rectification of per-simplex probabilities.

Rank by rank, bottom-up:

1. a simplex with any zero-probability face gets probability exactly 0, and
2. a simplex is never more probable than the geometric mean of its faces:
   ``rectified = min(raw, exp(mean(log(face_probs + eps))))``.

Edges mask from the raw vertex probs, triangles from the rectified edges,
tetra from the rectified triangles. Computed in float32 whatever the input
dtype, cast back to it.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import torch

from .complexes import ComplexTables


class RectifiedProbs(NamedTuple):
    """Per-rank rectified probabilities [..., S_r]."""

    vertices: torch.Tensor
    edges: torch.Tensor
    triangles: torch.Tensor
    tetra: torch.Tensor

    @property
    def ranks(self):
        return (self.vertices, self.edges, self.triangles, self.tetra)


@lru_cache(maxsize=16)
def face_indices(tables: ComplexTables, device: torch.device) -> tuple:
    """The static face tables (edges, tri_edges, tet_tris) as long tensors
    on ``device``, built once per (tables, device)."""
    with torch.inference_mode(False):
        return tuple(
            torch.as_tensor(idx, dtype=torch.long, device=device)
            for idx in (tables.edges, tables.tri_edges, tables.tet_tris)
        )


def _rectify_rank(raw: torch.Tensor, face_probs: torch.Tensor, face_idx: torch.Tensor, eps: float) -> torch.Tensor:
    """min(raw, geomean of the k faces), zeros propagated (gather form)."""
    log_faces = torch.log(face_probs + eps)
    geo = torch.exp(log_faces[..., face_idx].mean(dim=-1))  # [..., S]
    zero = (face_probs == 0.0)[..., face_idx].any(dim=-1)
    geo = torch.where(zero, torch.zeros_like(geo), geo)
    return torch.minimum(raw, geo)


def enforce_constraints(
    vertex_probs: torch.Tensor,
    edge_probs: torch.Tensor,
    triangle_probs: torch.Tensor,
    tetra_probs: torch.Tensor,
    tables: ComplexTables,
    eps: float = 1e-10,
) -> RectifiedProbs:
    """Rectify probabilities bottom-up so they form a valid (soft) complex.

    Accepts arbitrary leading batch dims. Vertices pass through unrectified.
    """
    in_dtype = vertex_probs.dtype
    v, e, t, tt = (
        p.to(torch.float32) for p in (vertex_probs, edge_probs, triangle_probs, tetra_probs)
    )
    edges, tri_edges, tet_tris = face_indices(tables, v.device)
    re = _rectify_rank(e, v, edges, eps)
    rt = _rectify_rank(t, re, tri_edges, eps)
    rtt = _rectify_rank(tt, rt, tet_tris, eps)
    return RectifiedProbs(*(p.to(in_dtype) for p in (v, re, rt, rtt)))
