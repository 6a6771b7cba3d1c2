"""The 1-D data mesh: one process per device, batches split by rows.

Port of ``topo_audio_autoencoder_tpu.parallel.mesh``. JAX runs one
program over a mesh of devices and lets XLA place the data and insert the
gradient all-reduce. PyTorch runs one process per device (``torchrun
--nproc_per_node=N``), so the mesh is a ``torch.distributed`` process
group and every collective is explicit:

- ``make_mesh`` joins (or makes) the process group: NCCL for the card,
  gloo for ``device="cpu"``, chosen by the device;
- ``shard_batch`` takes this rank's rows of a global batch and
  ``replicate`` broadcasts a state from rank 0. They do the work of the
  JAX module's ``batch_sharding`` and ``replicated``, placement objects
  that have no torch counterpart;
- ``mean_over_ranks`` averages tensors over the ranks in one all-reduce,
  ``gather_rows`` puts the ranks' rows back together, and ``row_shard``
  says which block of a global batch this rank holds.

The step computes what the 1-device step computes on the global batch:
every loss term is a mean over per-sample quantities, so the mean of the
ranks' means over equal shards is the global mean, and each random draw
is made at the global shape, each rank keeping its rows (``RowShard``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..device import resolve_device
from ..ops.samplers import RowShard


@dataclass(frozen=True)
class DataMesh:
    """One rank of the data mesh: its process group, its rank, the number
    of ranks, its device and the group's backend."""

    group: dist.ProcessGroup
    rank: int
    size: int
    device: torch.device
    backend: str
    owns_group: bool = False

    def close(self) -> None:
        """Destroy the process group if ``make_mesh`` made it."""
        if self.owns_group and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(
    n_devices: int | None = None,
    device=None,
    init_method: str | None = None,
    timeout: float | None = None,
) -> DataMesh:
    """This process's rank of the 1-D data mesh.

    The ranks are processes, one a device, started by ``torchrun
    --nproc_per_node=N`` (which sets ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT``). A process launched
    alone is a world of one on a local store. ``init_method`` (for example
    ``file://<path>``) replaces torchrun's rendezvous, with the rank and
    world size still read from ``RANK`` and ``WORLD_SIZE``. A process group
    the caller has already made is joined as it is, its backend the
    caller's.

    The device is ``cuda:LOCAL_RANK`` (made the current device) unless
    ``device`` asks for the CPU; the backend is NCCL on the card and gloo
    on the CPU. ``timeout`` (seconds) bounds every collective.

    The JAX package's ``make_mesh(n)`` takes the first n devices of one
    process. One process a device cannot: ``n_devices`` must equal the
    world size, and anything else raises.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    owns = not dist.is_initialized()
    size = int(os.environ.get("WORLD_SIZE", 1)) if owns else dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(
            f"n_devices={n_devices} but the process group has {size} rank(s): data parallelism "
            f"runs one process a device, started with torchrun --nproc_per_node={n_devices}"
        )
    if owns:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        kwargs = {"timeout": timedelta(seconds=timeout)} if timeout is not None else {}
        rank = int(os.environ.get("RANK", 0))
        if init_method is None and size == 1 and "MASTER_ADDR" not in os.environ:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1, **kwargs)
        else:
            dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                    world_size=size, **kwargs)
    return DataMesh(dist.group.WORLD, dist.get_rank(), dist.get_world_size(), dev, dist.get_backend(), owns)


def row_shard(mesh: DataMesh | None) -> RowShard | None:
    """The block of a global batch this rank holds (None without a mesh)."""
    return None if mesh is None else RowShard(mesh.rank, mesh.size)


def shard_batch(batch, mesh: DataMesh | None):
    """This rank's rows of ``batch`` (a numpy array or a tensor): block
    ``rank`` of ``size`` equal blocks of the leading axis (all of it
    without a mesh)."""
    if mesh is None:
        return batch
    b = batch.shape[0]
    if b % mesh.size:
        raise ValueError(f"a batch of {b} rows does not split over {mesh.size} ranks")
    n = b // mesh.size
    return batch[mesh.rank * n : (mesh.rank + 1) * n]


def _tensors(tree) -> list:
    """The tensors of a state: a tensor, a module's parameters, the fields
    of a dataclass, the values of a dict, the items of a list or tuple;
    anything else (counters) is left out."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters())
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        return [t for item in tree for t in _tensors(item)]
    return []


def _coalesced(tensors: list, collective) -> None:
    """Runs ``collective(buffer)`` once per dtype on the tensors flattened
    into one buffer, in order, and copies the result back in place."""
    by_dtype: dict = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    with torch.no_grad():
        for group in by_dtype.values():
            flat = torch.cat([t.detach().reshape(-1) for t in group])
            collective(flat)
            for t, part in zip(group, flat.split([t.numel() for t in group])):
                t.detach().copy_(part.view_as(t))


def replicate(tree, mesh: DataMesh):
    """Broadcasts every tensor of ``tree`` (a module's parameters, a
    dataclass such as ``TrainState`` or ``GridState``, dicts, lists) from
    rank 0, in place, and returns ``tree``. Python counters are the same
    on every rank by construction and are not sent."""
    _coalesced(_tensors(tree), lambda flat: dist.broadcast(flat, 0, group=mesh.group))
    return tree


def mean_over_ranks(tensors: list, mesh: DataMesh) -> list:
    """The mean of each tensor over the ranks: one all-reduce (sum) of the
    tensors flattened into one fp32 buffer, then / size. New tensors, in
    the input shapes, fp32; over one rank the bits are unchanged."""
    flat = torch.cat([t.detach().to(torch.float32).reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=mesh.group)
    flat = flat / mesh.size
    return [part.view(t.shape) for t, part in zip(tensors, flat.split([t.numel() for t in tensors]))]


def gather_rows(t: torch.Tensor, mesh: DataMesh | None) -> torch.Tensor:
    """The ranks' row blocks of ``t`` stacked in rank order: the global
    batch's rows back in their places (inverse of ``shard_batch``; ``t``
    itself without a mesh)."""
    if mesh is None:
        return t
    out = torch.empty((mesh.size * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t.contiguous(), group=mesh.group)
    return out


def pad_to_multiple(batch: np.ndarray, multiple: int):
    """Right-pad the batch dim to a multiple of ``multiple`` by repeating
    the last row; returns (padded, real_count)."""
    b = batch.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch, b
    pad = np.repeat(batch[-1:], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), b
