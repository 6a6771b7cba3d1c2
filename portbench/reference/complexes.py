"""Combinatorial structure of the complete simplicial complex on n vertices.

Index tables are enumerated with numpy; n fixes every shape (n=20 ->
20/190/1140/4845 simplices). The dense face memberships are built only
when asked for (at n=32 the tetrahedra's is [35960, 4960]).
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass, field
from functools import cached_property, lru_cache

import numpy as np

MAX_RANK = 3


def _combinations(n: int, k: int) -> np.ndarray:
    """All k-subsets of range(n) in lexicographic order, shape [C(n,k), k]."""
    combos = np.array(list(itertools.combinations(range(n), k)), dtype=np.int32)
    return combos.reshape(math.comb(n, k), k)


def _lookup_array(combos: np.ndarray, n: int) -> np.ndarray:
    """Dense lookup: sorted tuple of vertex ids -> simplex index."""
    k = combos.shape[1]
    lut = np.full((n,) * k, -1, dtype=np.int32)
    lut[tuple(combos[:, i] for i in range(k))] = np.arange(len(combos), dtype=np.int32)
    return lut


def _faces_of(combos: np.ndarray, face_lut: np.ndarray) -> np.ndarray:
    """For each k-simplex, indices of its (k-1)-faces, shape [S_k, k+1].

    Row i of ``combos`` lists the k+1 vertices of simplex i; dropping one
    vertex at a time yields its k+1 faces (each still sorted since combos are
    lexicographic). The face index comes from the dense lookup array.
    """
    kp1 = combos.shape[1]
    faces = []
    for drop in range(kp1):
        keep = [c for c in range(kp1) if c != drop]
        sub = combos[:, keep]  # [S, k]
        faces.append(face_lut[tuple(sub[:, i] for i in range(sub.shape[1]))])
    # Reference convention (rectifier.py:40-55) lists faces in lexicographic
    # order of the kept vertex sets, which equals dropping the LAST vertex
    # first. Order is irrelevant for membership matrices / geometric means,
    # but we keep a deterministic order: drop index descending.
    return np.stack(faces[::-1], axis=1).astype(np.int32)


def _membership(num_simplices: int, num_faces: int, face_idx: np.ndarray) -> np.ndarray:
    """0/1 matrix M[s, f] = 1 iff face f is a face of simplex s."""
    m = np.zeros((num_simplices, num_faces), dtype=np.float32)
    m[np.arange(num_simplices)[:, None], face_idx] = 1.0
    return m


@dataclass(frozen=True, eq=False)
class ComplexTables:
    """Static combinatorial tables for the complete complex on ``n`` vertices.

    - ``edges/triangles/tetra``: vertex-id tables [S_k, k+1]
    - ``tri_edges``: edge indices of each triangle [S_2, 3]
    - ``tet_tris``: triangle indices of each tetrahedron [S_3, 4]
    """

    n: int
    edges: np.ndarray
    triangles: np.ndarray
    tetra: np.ndarray
    tri_edges: np.ndarray
    tet_tris: np.ndarray

    # Derived scalars
    sizes: tuple[int, int, int, int] = field(default=(0, 0, 0, 0))

    @property
    def total_simplices(self) -> int:
        return sum(self.sizes)

    @cached_property
    def _memberships(self) -> dict:
        return {}

    def membership(self, rank: int) -> np.ndarray:
        """Face-membership matrix [S_rank, S_{rank-1}] (rank >= 1): v2e,
        e2t or t2tt, built on first use."""
        if rank not in self._memberships:
            faces = (self.edges, self.tri_edges, self.tet_tris)[rank - 1]
            self._memberships[rank] = _membership(self.sizes[rank], self.sizes[rank - 1], faces)
        return self._memberships[rank]

    def split(self, flat):
        """Split a [..., total_simplices] array into per-rank arrays."""
        v, e, t, tt = self.sizes
        return (
            flat[..., :v],
            flat[..., v : v + e],
            flat[..., v + e : v + e + t],
            flat[..., v + e + t :],
        )


@lru_cache(maxsize=8)
def build_tables(n: int, max_rank: int = MAX_RANK) -> ComplexTables:
    """Build all combinatorial tables for the complete complex on n vertices.

    ``max_rank`` < 3 truncates the hierarchy (e.g. 1 = vertices+edges only,
    BASELINE config 2): higher ranks get zero-size tables, which flow
    through the rectifier/builder/SCCN as empty (zero-cost) operands — no
    special-casing anywhere downstream.
    """
    if n < 2 or n < max_rank + 1:
        raise ValueError(f"need n >= max_rank+1 vertices, got n={n}")
    if not 1 <= max_rank <= 3:
        raise ValueError(f"max_rank must be in 1..3, got {max_rank}")
    edges = _combinations(n, 2)
    triangles = (
        _combinations(n, 3) if max_rank >= 2 else np.zeros((0, 3), np.int32)
    )
    tetra = (
        _combinations(n, 4) if max_rank >= 3 else np.zeros((0, 4), np.int32)
    )

    edge_lut = _lookup_array(edges, n)
    tri_lut = _lookup_array(triangles, n) if max_rank >= 2 else None

    tri_edges = (
        _faces_of(triangles, edge_lut)
        if max_rank >= 2
        else np.zeros((0, 3), np.int32)
    )  # [T, 3]
    tet_tris = (
        _faces_of(tetra, tri_lut)
        if max_rank >= 3
        else np.zeros((0, 4), np.int32)
    )  # [Tt, 4]

    return ComplexTables(
        n=n,
        edges=edges,
        triangles=triangles,
        tetra=tetra,
        tri_edges=tri_edges,
        tet_tris=tet_tris,
        sizes=(n, len(edges), len(triangles), len(tetra)),
    )
