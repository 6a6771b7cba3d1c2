"""Data-parallel helpers: for now only ``pad_to_multiple``."""

from .mesh import pad_to_multiple

__all__ = ["pad_to_multiple"]
