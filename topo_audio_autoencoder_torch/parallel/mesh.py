"""Batch padding for fixed-shape batches.

Port of ``pad_to_multiple`` from ``topo_audio_autoencoder_tpu.parallel.mesh``,
which ``Trainer.validate`` needs. The rest of that module (the 1-D device
mesh, batch sharding, replication) is still to come: on the card it becomes
DistributedDataParallel over NCCL (ROADMAP.md, Queue 1 item 6).
"""

from __future__ import annotations

import numpy as np


def pad_to_multiple(batch: np.ndarray, multiple: int):
    """Right-pad the batch dim to a multiple of ``multiple`` by repeating
    the last row; returns (padded, real_count)."""
    b = batch.shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return batch, b
    pad = np.repeat(batch[-1:], rem, axis=0)
    return np.concatenate([batch, pad], axis=0), b
