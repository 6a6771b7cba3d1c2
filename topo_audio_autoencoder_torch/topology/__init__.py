"""Simplicial-complex tables, closure rectifier, factored and packed operators."""

from .builder import SimplicialOperators, build_operators, dense_adjacency, same_rank_matmul
from .complexes import MAX_RANK, RANK_NAMES, ComplexTables, build_tables
from .packed import PackedOperators, build_packed_operators
from .rectifier import (
    RectifiedProbs,
    constraint_violations,
    enforce_constraints,
    enforce_constraints_flat,
)

__all__ = [
    "MAX_RANK",
    "RANK_NAMES",
    "ComplexTables",
    "PackedOperators",
    "RectifiedProbs",
    "SimplicialOperators",
    "build_operators",
    "build_packed_operators",
    "build_tables",
    "constraint_violations",
    "dense_adjacency",
    "enforce_constraints",
    "enforce_constraints_flat",
    "same_rank_matmul",
]
