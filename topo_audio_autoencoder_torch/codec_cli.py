"""Codec CLI: wav files <-> bit-packed simplicial-latent bitstreams.

Port of ``topo_audio_autoencoder_tpu.codec_cli``, with its three commands,
its flags and its ``.tac`` container bit for bit, so that a file written
by either package decodes in the other:

  encode     wavs -> one .tac bitstream file (775 B per 4 s clip at n=20)
  decode     .tac -> reconstructed wavs
  roundtrip  wav -> wav through the codec (encode + decode in one run)

``.tac`` container: magic ``TAC1`` + u32 header length + JSON header
(model geometry, clip count/length, sample rate) + the ``pack_latent``
bytes, clips concatenated. The header carries everything ``decode``
needs besides the trained parameters.

Parameters come from the port's own stores:

  --params DIR        an ``inference.save_params`` directory (a state_dict)
  --checkpoint DIR    a Trainer run's checkpoint dir; ``--name`` picks the
                      snapshot (default ``best``), params are read out of
                      the saved train state (``state["params"]``, keyed by
                      parameter name).

Model geometry resolves from: explicit CLI flag > ``.tac`` header >
the checkpoint's sidecar stamp (``<name>.extra.json``'s ``"model"``) >
built-in defaults; a flag that disagrees with the stamp is a hard error.
``encode`` does not write ``pack_capacities`` into the header, as the JAX
CLI does not: a packed model's ``.tac`` decodes with ``--checkpoint``.

One flag more than the JAX CLI: ``--device`` (default: the CUDA card,
which raises without one; ``--device cpu`` runs the plain path).

Usage:
    python -m topo_audio_autoencoder_torch.codec_cli encode out.tac a.wav b.wav \
        --checkpoint runs/checkpoints --name best
    python -m topo_audio_autoencoder_torch.codec_cli decode out.tac recon_dir/
    python -m topo_audio_autoencoder_torch.codec_cli roundtrip in.wav out.wav \
        --params params_dir --device cpu
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
from pathlib import Path

import numpy as np

MAGIC = b"TAC1"


def write_tac(path, packed: np.ndarray, header: dict) -> None:
    """``packed`` is the [num_clips, bytes_per_clip] uint8 wire format."""
    head = json.dumps(header).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        f.write(np.ascontiguousarray(packed, dtype=np.uint8).tobytes())


def read_tac(path) -> tuple[np.ndarray, dict]:
    raw = Path(path).read_bytes()
    if raw[:4] != MAGIC:
        raise ValueError(f"{path}: not a .tac file (bad magic {raw[:4]!r})")
    (hlen,) = struct.unpack("<I", raw[4:8])
    header = json.loads(raw[8 : 8 + hlen].decode("utf-8"))
    body = np.frombuffer(raw[8 + hlen :], dtype=np.uint8)
    packed = body.reshape(header["num_clips"], header["bytes_per_clip"])
    return packed, header


_GEOM_DEFAULTS = {
    "vertices": 20, "bands": 16, "hidden": 64, "layers": 6,
    "sampler": "gumbel", "hard": False, "learned_hc": False,
}


def _resolve_geometry(args, header: dict | None) -> dict:
    """Model geometry from: explicit CLI flag > ``.tac`` header > checkpoint
    sidecar stamp > built-in default.

    Trainer checkpoints stamp their architecture into the ``.extra.json``
    sidecar (``AudioAutoencoder.geometry``), so a plain ``--checkpoint`` is
    enough; any disagreement between explicit sources is a hard error —
    a silent mismatch would decode garbage."""
    side = {}
    if args.checkpoint:
        from .training.checkpoint import CheckpointManager

        extra = CheckpointManager(args.checkpoint).load_extra(
            args.name or "best"
        )
        side = (extra or {}).get("model") or {}
    geom = {}
    for k, dflt in _GEOM_DEFAULTS.items():
        sources = {}
        cli = getattr(args, k, None)
        if cli is not None:
            sources[f"--{k}"] = cli
        if header and k in header:
            sources[".tac header"] = header[k]
        if k in side:
            sources["checkpoint sidecar"] = side[k]
        if len(set(sources.values())) > 1:
            raise SystemExit(
                f"model geometry mismatch for '{k}': "
                + ", ".join(f"{s}={v}" for s, v in sources.items())
            )
        geom[k] = next(iter(sources.values()), dflt)
    # Packed-operator capacities ride the sidecar stamp only (no CLI flag
    # — they are an architecture fact of the trained model); the header
    # may carry them for checkpoint-free decode.
    pc = side.get("pack_capacities")
    if header and header.get("pack_capacities") is not None:
        pc = header["pack_capacities"]
    geom["pack_capacities"] = tuple(pc) if pc is not None else None
    return geom


def _build_model(geom: dict, num_samples: int, device):
    """The model of ``geom`` on ``device``; ``num_samples`` is the clip
    length its encoder's MLP is sized for (flax infers it at init)."""
    from .models import AudioAutoencoder

    return AudioAutoencoder.create(
        num_vertices=geom["vertices"],
        num_bands=geom["bands"],
        sccn_hidden_dim=geom["hidden"],
        n_sccn_layers=geom["layers"],
        max_active_vertices=geom["vertices"],
        num_samples=num_samples,
        device=device,
        sampler=geom["sampler"],
        hard=geom["hard"],
        learned_hc=geom.get("learned_hc", False),
        pack_capacities=geom.get("pack_capacities"),
    )


def _load_params(args, template: dict) -> dict:
    from .training.checkpoint import CheckpointManager

    if args.params:
        return CheckpointManager(args.params).restore(args.name or "params", template=template)
    if args.checkpoint:
        state = CheckpointManager(args.checkpoint).restore(args.name or "best")
        # Trainer checkpoints hold the full train state; the parameters sit
        # under "params", keyed by parameter name.
        return state["params"] if "params" in state else state
    raise SystemExit("one of --params / --checkpoint is required")


def _codec(args, num_samples: int, header: dict | None = None):
    from .device import resolve_device
    from .inference import Codec

    device = resolve_device(args.device)
    geom = _resolve_geometry(args, header)
    _check_gran(geom["bands"], num_samples)
    model = _build_model(geom, num_samples, device)
    return model, Codec(model, _load_params(args, model.state_dict()), device=device), geom


def _check_gran(bands: int, clip_samples: int) -> None:
    """The decoder's four x2 upsamples fix the per-band output length to a
    multiple of 16; an indivisible window fails opaquely inside the decoder
    (or misaligns windows) — fail clearly up front instead."""
    gran = bands * 16
    if clip_samples % gran:
        raise SystemExit(f"--clip-samples must be divisible by {gran}")


def _load_windows(paths, clip_samples: int, sample_rate: int):
    """Load wavs and split into fixed ``clip_samples`` windows (pad the
    last). The encoder's logit MLP is sized for the trained clip length, so
    a checkpoint only encodes windows of exactly that length — arbitrary
    audio is coded as a sequence of windows, one latent each.

    Returns ([N_windows, 1, clip_samples] batch,
             [(name, num_windows, orig_samples), ...] manifest)."""
    from .data.preprocess import load_wav

    windows, files = [], []
    for p in paths:
        x = load_wav(p, sample_rate)
        n_win = max(1, -(-len(x) // clip_samples))
        padded = np.zeros(n_win * clip_samples, dtype=np.float32)
        padded[: len(x)] = x
        windows.append(padded.reshape(n_win, 1, clip_samples))
        files.append((Path(p).stem, n_win, len(x)))
    return np.concatenate(windows, axis=0), files


def cmd_encode(args) -> None:
    from .inference import pack_latent

    model, codec, geom = _codec(args, args.clip_samples)
    batch, files = _load_windows(args.wavs, args.clip_samples, args.sample_rate)
    wire = []
    for i in range(0, len(batch), args.batch):  # bound device memory
        wire.append(pack_latent(codec.encode(batch[i : i + args.batch])))
    wire = np.concatenate(wire, axis=0)
    header = {
        "vertices": model.tables.num_vertices,
        "bands": model.num_bands,
        "hidden": geom["hidden"],
        "layers": geom["layers"],
        "sampler": geom["sampler"],
        "hard": geom["hard"],
        "learned_hc": geom.get("learned_hc", False),
        "num_clips": int(wire.shape[0]),
        "bytes_per_clip": int(wire.shape[1]),
        "num_samples": args.clip_samples,
        "sample_rate": args.sample_rate,
        "files": files,
    }
    write_tac(args.out, wire, header)
    kbps = wire.shape[1] * 8 * args.sample_rate / args.clip_samples / 1000.0
    print(json.dumps({
        "files": len(files),
        "windows": header["num_clips"],
        "bytes_per_clip": header["bytes_per_clip"],
        "kbit_per_sec": round(kbps, 3),
        "out": str(args.out),
    }))


def cmd_decode(args) -> None:
    from .data.preprocess import save_wav
    from .inference import unpack_latent

    packed, header = read_tac(args.tac)
    model, codec, _ = _codec(args, header["num_samples"], header)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    wavs = []
    for i in range(0, len(packed), args.batch):
        lat = unpack_latent(packed[i : i + args.batch], header["vertices"])
        wavs.append(codec.decode(lat, header["num_samples"]).cpu().numpy())
    wavs = np.concatenate(wavs, axis=0)
    written, w = [], 0
    files = header.get("files") or [
        (f"clip_{i:04d}", 1, header["num_samples"])
        for i in range(header["num_clips"])
    ]
    for name, n_win, orig in files:
        flat = wavs[w : w + n_win, 0].reshape(-1)[:orig]
        w += n_win
        p = out_dir / f"{name}.wav"
        save_wav(p, flat, header["sample_rate"])
        written.append(str(p))
    print(json.dumps({"files": len(written), "out_dir": str(out_dir)}))


def cmd_roundtrip(args) -> None:
    from .data.preprocess import save_wav
    from .inference import pack_latent, unpack_latent

    model, codec, _ = _codec(args, args.clip_samples)
    batch, files = _load_windows([args.wav], args.clip_samples, args.sample_rate)
    wire = pack_latent(codec.encode(batch))
    lat = unpack_latent(wire, model.tables.num_vertices)
    wav = codec.decode(lat, args.clip_samples).cpu().numpy()
    flat = wav[:, 0].reshape(-1)[: files[0][2]]
    save_wav(args.out, flat, args.sample_rate)
    print(json.dumps({
        "windows": int(wire.shape[0]),
        "bytes": int(wire.shape[0] * wire.shape[1]),
        "num_samples": int(files[0][2]),
        "out": str(args.out),
    }))


def main(argv: list[str] | None = None) -> None:
    p = argparse.ArgumentParser(prog="topo_audio_autoencoder_torch.codec_cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, geometry: bool):
        sp.add_argument("--params", help="save_params directory")
        sp.add_argument("--checkpoint", help="Trainer checkpoint directory")
        sp.add_argument("--name", help="snapshot name (default best/params)")
        sp.add_argument("--batch", type=int, default=16)
        sp.add_argument("--sample-rate", type=int, default=16000)
        sp.add_argument(
            "--device", default=None,
            help="torch device (default: the CUDA card; 'cpu' runs the plain path)",
        )
        # Geometry defaults are None: an omitted flag defers to the .tac
        # header / checkpoint sidecar stamp (_resolve_geometry); an explicit
        # flag that disagrees with either is a hard error.
        if geometry:  # decode reads geometry from the .tac header instead
            sp.add_argument("--vertices", type=int, default=None)
            sp.add_argument("--bands", type=int, default=None)
            sp.add_argument(
                "--clip-samples", type=int, default=64000,
                help="window length the checkpoint was trained at; audio "
                     "is coded as a sequence of such windows",
            )
        sp.add_argument("--hidden", type=int, default=None)
        sp.add_argument("--layers", type=int, default=None)

    e = sub.add_parser("encode", help="wavs -> .tac bitstream")
    e.add_argument("out")
    e.add_argument("wavs", nargs="+")
    common(e, geometry=True)
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode", help=".tac -> wavs")
    d.add_argument("tac")
    d.add_argument("out_dir")
    common(d, geometry=False)
    d.set_defaults(fn=cmd_decode)

    r = sub.add_parser("roundtrip", help="wav -> wav through the codec")
    r.add_argument("wav")
    r.add_argument("out")
    common(r, geometry=True)
    r.set_defaults(fn=cmd_roundtrip)

    args = p.parse_args(argv if argv is not None else sys.argv[1:])
    args.fn(args)


if __name__ == "__main__":
    main()
