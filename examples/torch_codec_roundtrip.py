"""Codec demo on the PyTorch port: waveform -> 1-bit-per-simplex latent ->
bytes -> waveform.

    python examples/torch_codec_roundtrip.py [checkpoint_dir] [--packed] [--device cpu]

With a checkpoint directory of the port's ``Trainer`` (its ``best``
checkpoint and ``best.extra.json``'s model geometry), encodes a synthetic
clip with the trained model; without one, uses fresh seeded parameters
(the pipeline is the point: quality needs training). ``--packed`` decodes
an n >= 32 model through the static-capacity packed operators
(``topology/packed.py``), exact for the sparse thresholded latent. Runs on
the CUDA card unless ``--device cpu`` is given.

Prints the latent size (775 B per 4 s clip at n=20, 5,181 B at n=32:
about 1.55 and 10.4 kbit/s against 128 kB of raw PCM16) and the decode's
spectral distance to the input.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from topo_audio_autoencoder_torch.data import synth_corpus
from topo_audio_autoencoder_torch.inference import Codec, pack_latent, unpack_latent
from topo_audio_autoencoder_torch.models import AudioAutoencoder
from topo_audio_autoencoder_torch.ops.stft import spectral_distance
from topo_audio_autoencoder_torch.training import CheckpointManager

NUM_SAMPLES = 64000
PACK_CAPACITIES = (0, 0, 512, 256)


def main(argv=None, num_samples: int = NUM_SAMPLES) -> dict:
    """Runs the demo; returns the wire bytes per clip and the spectral
    distance. ``num_samples`` cuts the clip (and the model's encoder)."""
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint_dir", nargs="?")
    parser.add_argument("--packed", action="store_true")
    parser.add_argument("--device", default=None, help="cpu, or a CUDA device (default: the card)")
    args = parser.parse_args(argv)

    geom = {"vertices": 20, "hidden": 64, "layers": 6}
    params = None
    if args.checkpoint_dir:
        ck = CheckpointManager(args.checkpoint_dir)
        extra = ck.load_extra("best") or {}
        geom.update(extra.get("model") or {})
        params = ck.restore("best")["params"]
        print(f"loaded 'best' from {args.checkpoint_dir} (n={geom['vertices']})")

    n = geom["vertices"]
    model = AudioAutoencoder.create(
        num_vertices=n,
        sccn_hidden_dim=geom["hidden"],
        n_sccn_layers=geom["layers"],
        max_active_vertices=n,
        pack_capacities=PACK_CAPACITIES if args.packed and n >= 32 else None,
        num_samples=num_samples,
        device=args.device,
    )
    if params is None:
        print("no checkpoint given: fresh (untrained) parameters")
    x = torch.from_numpy(synth_corpus(1, n_samples=num_samples, seed=7))[:, None, :]

    codec = Codec(model, params, device=args.device)
    latent = codec.encode(x)
    wire = pack_latent(latent)
    print(f"latent: {model.tables.total_simplices} bits -> {wire.shape[-1]} bytes per "
          f"{num_samples / 16000:g} s clip (raw PCM16: {2 * x.shape[-1]:,} bytes)")

    decoded = codec.decode(unpack_latent(wire, n), x.shape[-1])
    spec = float(spectral_distance(decoded[:, 0], x.to(decoded.device)[:, 0]).mean())
    print(f"roundtrip spectral distance: {spec:.3f}" + ("" if args.checkpoint_dir else "  (untrained: expect large)"))
    return {"bits": model.tables.total_simplices, "wire_bytes": int(wire.shape[-1]), "spectral_distance": spec,
            "waveform": decoded, "finite": bool(np.isfinite(spec) and torch.isfinite(decoded).all())}


if __name__ == "__main__":
    main()
