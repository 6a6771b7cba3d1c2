"""Data parallelism: the 1-D data mesh over ``torch.distributed``."""

from .mesh import (
    DataMesh,
    gather_rows,
    make_mesh,
    mean_over_ranks,
    pad_to_multiple,
    replicate,
    row_shard,
    shard_batch,
)

__all__ = [
    "DataMesh",
    "gather_rows",
    "make_mesh",
    "mean_over_ranks",
    "pad_to_multiple",
    "replicate",
    "row_shard",
    "shard_batch",
]
