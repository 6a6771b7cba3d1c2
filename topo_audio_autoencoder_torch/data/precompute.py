"""On-device O(N²) pairwise spectral-distance precompute.

Port of ``topo_audio_autoencoder_tpu.data.precompute``: the replacement for
the reference's offline distance stage (reference:
precompute_distances.py:51-153), which looped over 523,776 upper-triangle
pairs in Python batches of 32, recomputing both STFTs for every pair on
the CPU. Here:

- the N×N matrix is filled tile pair by tile pair with
  ``spectral_distance_matrix_block``, each tile's STFTs computed inside
  its block, as the JAX package does;
- only the upper triangle of tiles is computed, into an [N, N] matrix that
  stays on the device; one copy back at the end, then the mirror on the
  host.

Outputs match the reference's artifacts: the full distance matrix and, per
row, the complete nearest→farthest neighbor ordering
(precompute_distances.py:121-143), saved as one ``.npz`` that either
package reads.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops.stft import DEFAULT_SCALES, spectral_distance_matrix_block


def _tiled_upper(xs: torch.Tensor, tile: int, scales) -> torch.Tensor:
    """The upper-triangle tile sweep: [N, N] with tile pairs (i, j), i <= j,
    filled. A Python loop of device work with nothing in it that waits for
    the device (the JAX package's ``lax.scan`` exists to avoid host round
    trips; an eager loop that never synchronizes has none)."""
    n = xs.shape[0]
    nt = n // tile
    out = torch.zeros(n, n, dtype=torch.float32, device=xs.device)
    for i in range(nt):
        xi = xs[i * tile : (i + 1) * tile]
        for j in range(i, nt):
            out[i * tile : (i + 1) * tile, j * tile : (j + 1) * tile] = spectral_distance_matrix_block(
                xi, xs[j * tile : (j + 1) * tile], scales
            )
    return out


def compute_distance_matrix(
    waveforms: np.ndarray,
    tile: int = 64,
    scales: tuple[int, ...] = DEFAULT_SCALES,
    device=None,
) -> np.ndarray:
    """Full symmetric pairwise spectral-distance matrix, computed on
    ``device`` (the CUDA card unless the caller passes ``"cpu"``).

    waveforms: [N, T] float32 (padded to equal length, like
    precompute_distances.py:77-86). Returns [N, N] float32 with zero
    diagonal. The distance is not symmetric in general (the linear term
    normalizes by x's energy); like the reference, d(i, j) with i < j is
    taken for both entries (:113-115). The corpus is zero-padded to a whole
    number of tiles; the padded rows and columns are sliced off before the
    mirror.
    """
    device = resolve_device(device)
    n = len(waveforms)
    tile = min(tile, n)
    pad = (-n) % tile
    xs = torch.as_tensor(np.asarray(waveforms, dtype=np.float32)).to(device)
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
    with torch.no_grad():
        full = _tiled_upper(xs, tile, scales)
    out = full[:n, :n].cpu().numpy().copy()  # the one copy back
    iu = np.triu_indices(n, 1)
    out[(iu[1], iu[0])] = out[iu]  # mirror upper -> lower
    np.fill_diagonal(out, 0.0)
    return out


def sort_neighbors(distances: np.ndarray) -> np.ndarray:
    """Per-row nearest→farthest ordering, self excluded
    (precompute_distances.py:121-125). Returns [N, N-1] int32.

    A stable argsort, then each row's own index removed wherever it lands
    (a tie at distance 0 may put another row before it)."""
    n = len(distances)
    order = np.argsort(distances, axis=1, kind="stable")
    keep = order != np.arange(n)[:, None]
    return order[keep].reshape(n, n - 1).astype(np.int32)


def compute_distances(
    waveforms: np.ndarray,
    save_path: str | Path | None = None,
    tile: int = 64,
    scales: tuple[int, ...] = DEFAULT_SCALES,
    device=None,
) -> dict:
    """End-to-end precompute: distances and neighbor ordering (and save).

    Mirrors ``compute_distances`` (precompute_distances.py:51-153); the
    ``.npz`` holds {'distances': [N,N], 'neighbors': [N,N-1]}.
    """
    distances = compute_distance_matrix(waveforms, tile, scales, device)
    neighbors = sort_neighbors(distances)
    result = {"distances": distances, "neighbors": neighbors}
    if save_path is not None:
        path = Path(save_path)
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, **result)
    return result


def load_distances(path: str | Path) -> dict:
    with np.load(path) as z:
        return {"distances": z["distances"], "neighbors": z["neighbors"]}
