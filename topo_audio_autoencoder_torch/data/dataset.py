"""NSynth contrastive dataset + batched host pipeline.

Port of ``topo_audio_autoencoder_tpu.data.dataset``: the sampling is the
same NumPy code, so the same seeds give the same indices, batches, shuffle
order and per-batch seeds (``seed + epoch * 100003 + start``);
``prefetch_to_device`` places batches with torch, on the card unless the
caller asks for the CPU. Equivalent of the reference ``NSynthDataset``
(reference: nsyth_dataset.py:7-72) with its curriculum negative sampler,
re-designed as a batched, seeded, prefetching pipeline instead of a
batch-1 map-style dataset:

- Waveforms live in one [N, T] float32 array (memory-mapped for large
  corpora) instead of N separate ``.pt`` files.
- Train items are stacks of [anchor, positive, negatives...] —
  positive uniform from the ``num_positive_neighbors`` nearest
  (nsyth_dataset.py:52-54), negatives a ``num_negative_samples``-wide
  window ending at ``current_negative_offset`` into the nearest→farthest
  ordering, which decays ×0.90 per epoch toward a floor of 100
  (nsyth_dataset.py:31-41,57-62) — the curriculum that hardens negatives
  over time.
- Batches come out [B, G, 1, T] ready for the contrastive train step.
"""

from __future__ import annotations

import collections
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from .native_loader import gather_batch


@dataclass
class ContrastiveConfig:
    num_positive_neighbors: int = 10
    num_negative_samples: int = 10
    offset_decay_rate: float = 0.90
    min_negative_offset: int = 100


class NSynthDataset:
    """Map-style access with contrastive sampling; NOT tied to NSynth —
    any [N, T] waveform corpus + neighbor ordering works."""

    def __init__(
        self,
        waveforms: np.ndarray,  # [N, T]
        neighbors: np.ndarray | None = None,  # [N, N-1] nearest->farthest
        train: bool = False,
        config: ContrastiveConfig = ContrastiveConfig(),
        seed: int = 511990,
    ):
        self.waveforms = waveforms
        self.neighbors = neighbors
        self.train = train
        self.config = config
        self.epoch = 0
        self.rng = np.random.default_rng(seed)
        n = len(waveforms)
        self.initial_negative_offset = n
        self.current_negative_offset = min(n - 1, n)
        if train and neighbors is None:
            raise ValueError("train mode needs a neighbor ordering")

    def set_epoch(self, epoch: int) -> None:
        """Decay the negative-sampling offset (nsyth_dataset.py:31-41)."""
        self.epoch = epoch
        c = self.config
        self.current_negative_offset = max(
            c.min_negative_offset,
            int(self.initial_negative_offset * c.offset_decay_rate**epoch),
        )
        # clamp into the valid neighbor range for small corpora
        max_off = self.neighbors.shape[1] if self.neighbors is not None else 0
        self.current_negative_offset = min(self.current_negative_offset, max_off)

    def __len__(self) -> int:
        return len(self.waveforms)

    @property
    def group_size(self) -> int:
        return 2 + self.config.num_negative_samples if self.train else 1

    def __getitem__(self, idx: int) -> np.ndarray:
        """Train: [G, 1, T] contrastive stack; eval: [1, T]."""
        wav = self.waveforms[idx]
        if not self.train:
            return wav[None, :]
        c = self.config
        order = self.neighbors[idx]
        k = min(c.num_positive_neighbors, len(order))
        positive = order[self.rng.integers(0, k)]
        neg_end = self.current_negative_offset
        neg_start = max(0, neg_end - c.num_negative_samples)
        negatives = order[neg_start:neg_end]
        idxs = np.concatenate([[idx, positive], negatives])
        return self.waveforms[idxs][:, None, :]

    def sample_batch_indices(self, idxs: np.ndarray, seed: int) -> np.ndarray:
        """Index-only batch assembly: [B, G] int32 of corpus rows
        (anchor, positive, negatives...), same sampling semantics as
        ``sample_batch``. For the device-resident-corpus path: the corpus
        lives in HBM once and the train step gathers rows on device, so
        each step ships B*G*4 bytes instead of B*G*T*4 (the reference
        reloads waveforms from disk per item, nsyth_dataset.py:48-62).
        """
        if not self.train:
            return np.asarray(idxs, dtype=np.int32)[:, None]
        c = self.config
        rng = np.random.default_rng(seed)
        idxs = np.asarray(idxs)
        n_nb = self.neighbors.shape[1]
        neg_end = min(self.current_negative_offset, n_nb)
        neg_start = max(0, neg_end - c.num_negative_samples)
        # Fully vectorized batch assembly (~40x the per-anchor Python loop
        # this replaces — the host must outrun the device to keep the
        # prefetch queue full).
        pos_choice = rng.integers(
            0, min(c.num_positive_neighbors, n_nb), size=len(idxs)
        )
        pos = self.neighbors[idxs, pos_choice]  # [B]
        if neg_end <= neg_start:
            # An empty window would silently substitute column 0 — each
            # anchor's NEAREST neighbor — as every contrastive negative,
            # poisoning the InfoNCE term. Fail loudly instead.
            raise ValueError(
                f"empty negative window [{neg_start}, {neg_end}): corpus too "
                f"small for num_negative_samples={c.num_negative_samples} at "
                f"offset {self.current_negative_offset}"
            )
        neg_cols = np.arange(neg_start, neg_end)
        if len(neg_cols) < c.num_negative_samples:  # tiny-corpus edge pad
            neg_cols = np.pad(
                neg_cols, (0, c.num_negative_samples - len(neg_cols)),
                mode="edge",
            )
        negs = self.neighbors[idxs[:, None], neg_cols[None, :]]  # [B, K]
        return np.concatenate(
            [idxs[:, None], pos[:, None], negs], axis=1
        ).astype(np.int32)

    def sample_batch(self, idxs: np.ndarray, seed: int) -> np.ndarray:
        """Assemble a whole batch at once: sample indices, gather rows.

        Train: [B, G, 1, T]; eval: [B, 1, T].

        Sampling lives in ONE place (``sample_batch_indices``), so the
        array path and the device-resident-corpus index path draw the
        same positives/negatives from the same seed — bit-identical
        batches either way. The expensive part — copying B*G*T floats — goes through the native
        (C++) gather. (``assemble_contrastive_batch``, the single-call
        native assembly with its own C++ RNG stream, remains available in
        ``native_loader`` for hosts where Python index sampling is the
        bottleneck.)
        """
        if not self.train:
            return gather_batch(np.asarray(self.waveforms), idxs)[:, None, :]
        idx = self.sample_batch_indices(idxs, seed)  # [B, G]
        b, g = idx.shape
        flat = gather_batch(
            np.asarray(self.waveforms), idx.reshape(-1).astype(np.int32)
        )
        return flat.reshape(b, g, 1, -1)


def batch_iterator(
    dataset: NSynthDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 511990,
    epoch: int = 0,
    drop_remainder: bool = True,
):
    """Seeded batched iteration; train batches are [B, G, 1, T], eval
    [B, 1, T]. Replaces the reference's batch-1 DataLoader
    (trainer.py:93-95)."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    stop = n - (n % batch_size) if drop_remainder else n
    for start in range(0, stop, batch_size):
        idxs = order[start : start + batch_size]
        yield dataset.sample_batch(idxs, seed + epoch * 100003 + start)


def index_iterator(
    dataset: NSynthDataset,
    batch_size: int,
    shuffle: bool = True,
    seed: int = 511990,
    epoch: int = 0,
    drop_remainder: bool = True,
):
    """Like ``batch_iterator`` but yields [B, G] index matrices for the
    device-resident-corpus train path (see ``sample_batch_indices``)."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed + epoch).shuffle(order)
    stop = n - (n % batch_size) if drop_remainder else n
    for start in range(0, stop, batch_size):
        idxs = order[start : start + batch_size]
        yield dataset.sample_batch_indices(idxs, seed + epoch * 100003 + start)


class _PinnedCopy:
    """Host batches to a CUDA device: each is copied into pinned memory and
    sent with ``non_blocking=True`` on a side stream, so the copy overlaps
    the compute stream's work. A pinned buffer is held until the event
    recorded after its copy has completed, so none is freed or reused while
    its copy is in flight."""

    def __init__(self, device: torch.device):
        self.device = device
        self.stream = torch.cuda.Stream(device)
        self.in_flight = []  # (pinned host tensor, its copy's event)

    def put(self, item) -> tuple:
        self.in_flight = [(h, e) for h, e in self.in_flight if not e.query()]
        host = torch.from_numpy(np.ascontiguousarray(item)).pin_memory()
        with torch.cuda.stream(self.stream):
            placed = host.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self.stream)
        self.in_flight.append((host, done))
        return placed, done

    def take(self, entry) -> torch.Tensor:
        """The placed batch, made safe for the current stream: its work
        waits for the copy, and the allocator learns of the second stream."""
        placed, done = entry
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        placed.record_stream(stream)
        return placed

    def close(self) -> None:
        for _, done in self.in_flight:
            done.synchronize()
        self.in_flight = []


def prefetch_to_device(iterator, size: int = 2, put=None, device=None):
    """Simple device prefetch: keep ``size`` batches in flight.

    The reference has no async loading at all (SURVEY §2.3); this overlaps
    host batch assembly and the host-to-device copy with device compute.
    ``put`` overrides the placement; by default each batch goes to
    ``device``, the CUDA card unless the caller passes ``"cpu"``: on the
    card through pinned memory and a side stream (``_PinnedCopy``), on the
    CPU as a tensor over the batch's own memory (nothing is pinned).
    """
    take = close = None
    if put is None:
        device = resolve_device(device)
        if device.type == "cuda":
            copier = _PinnedCopy(device)
            put, take, close = copier.put, copier.take, copier.close
        else:
            def put(item):
                return torch.as_tensor(np.asarray(item), device=device)
    queue = collections.deque()

    def enqueue(k):
        for _, item in zip(range(k), iterator):
            queue.append(put(item))

    try:
        enqueue(size)
        while queue:
            entry = queue.popleft()
            yield take(entry) if take else entry
            enqueue(1)
    finally:
        if close:
            close()
