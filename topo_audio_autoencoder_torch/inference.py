"""Codec view of the autoencoder: waveform -> binary simplicial latent ->
waveform, and the bit-packed wire format.

Port of ``topo_audio_autoencoder_tpu.inference`` (without the parameter
save/load, which comes with the checkpoint slice).

- ``Codec.encode``: waveform -> per-rank latent (the deterministic eval
  path: the noiseless relaxation, rectified; binary for the Gumbel sampler
  and for ``hard`` models, continuous for a soft Hard Concrete model).
- ``Codec.decode``: latent -> waveform, rebuilding embeddings and operators
  from the latent alone.
- ``Codec.reconstruct``: encode + decode in one forward.
- ``pack_latent`` / ``unpack_latent``: one bit per simplex,
  ``ceil((n + C(n,2) + C(n,3) + C(n,4)) / 8)`` bytes per clip (n=20: 775
  bytes). The byte layout is the JAX package's, so either package decodes
  the other's bytes.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .device import resolve_device
from .models.autoencoder import AudioAutoencoder
from .topology.rectifier import RectifiedProbs


class SimplicialLatent(NamedTuple):
    """The discrete code: per-rank probabilities (binary at eval), [B, S_r]."""

    vertices: torch.Tensor
    edges: torch.Tensor
    triangles: torch.Tensor
    tetra: torch.Tensor

    @property
    def ranks(self):
        return (self.vertices, self.edges, self.triangles, self.tetra)


class Codec:
    """Eval-mode codec over an autoencoder.

    ``params``, when given, is a ``state_dict`` (for example from
    ``convert.state_dict_from_flax``) loaded into ``model``. The model is
    moved to ``device``: ``cuda`` by default, which raises without a card.
    """

    def __init__(self, model: AudioAutoencoder, params=None, device=None):
        self.device = resolve_device(device)
        if params is not None:
            model.load_state_dict(params)
        self.model = model.to(self.device).eval()

    def _tensor(self, x) -> torch.Tensor:
        """A float32 tensor on the codec's device (numpy input is copied)."""
        if not isinstance(x, torch.Tensor):
            x = torch.tensor(np.asarray(x))
        return x.to(device=self.device, dtype=torch.float32)

    @torch.inference_mode()
    def encode(self, x) -> SimplicialLatent:
        """[B, 1, T] -> binary simplicial latent."""
        enc = self.model.encode(self._tensor(x))
        return SimplicialLatent(*enc.probs.ranks)

    @torch.inference_mode()
    def decode(self, latent: SimplicialLatent, num_samples: int) -> torch.Tensor:
        """latent -> [B, 1, num_samples]."""
        probs = RectifiedProbs(*(self._tensor(r) for r in latent.ranks))
        return self.model.decode_from_probs(probs, num_samples // self.model.num_bands)

    @torch.inference_mode()
    def reconstruct(self, x) -> torch.Tensor:
        return self.model(self._tensor(x)).waveform


def pack_latent(latent) -> np.ndarray:
    """Latent -> ``[..., ceil(S_total/8)]`` uint8 bitstream.

    Ranks concatenate in order (vertices, edges, triangles, tetra) along the
    last axis before packing. Binarization thresholds at 0.5: lossless for
    the binary latents of the Gumbel eval path; a Hard Concrete model's
    eval latent is continuous (``hard=False``) or binary only to an ulp
    (``hard=True``: the straight-through sum), and quantizes here.
    ``Codec.decode`` re-rectifies, so a thresholded latent decodes as a
    valid complex.
    """
    def host(r):
        return r.detach().cpu().numpy() if isinstance(r, torch.Tensor) else np.asarray(r)

    bits = np.concatenate([host(r) >= 0.5 for r in latent.ranks], axis=-1)
    return np.packbits(bits.astype(np.uint8), axis=-1)


def unpack_latent(
    packed: np.ndarray, num_vertices: int, dtype=torch.float32
) -> SimplicialLatent:
    """Inverse of :func:`pack_latent` for a complete complex on
    ``num_vertices`` vertices; returns CPU tensors."""
    sizes = [math.comb(num_vertices, k) for k in range(1, 5)]
    bits = np.unpackbits(np.asarray(packed, dtype=np.uint8), axis=-1, count=sum(sizes))
    splits = np.split(bits, np.cumsum(sizes)[:-1], axis=-1)
    return SimplicialLatent(*(torch.from_numpy(s.copy()).to(dtype) for s in splits))
