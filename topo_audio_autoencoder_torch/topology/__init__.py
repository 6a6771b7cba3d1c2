"""Simplicial-complex tables, closure rectifier and factored operators."""

from .builder import SimplicialOperators, build_operators
from .complexes import ComplexTables, build_tables
from .rectifier import (
    RectifiedProbs,
    constraint_violations,
    enforce_constraints,
    enforce_constraints_flat,
)

__all__ = [
    "ComplexTables",
    "RectifiedProbs",
    "SimplicialOperators",
    "build_operators",
    "build_tables",
    "constraint_violations",
    "enforce_constraints",
    "enforce_constraints_flat",
]
