"""Host-side corpus preprocessing: WAV files -> one packed waveform array.

Port of ``topo_audio_autoencoder_tpu.data.preprocess`` (NumPy and scipy
only, so the same code): scipy for WAV I/O and polyphase resampling, the
native decoder first for each file. The corpus packs into a single float32
array, memory-mapped at load: one sequential read at train time instead of
N file opens.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from .native_loader import load_wav_native


def load_wav(path: str | Path, target_sr: int = 16000) -> np.ndarray:
    """Load, mono-ize, resample, normalize to float32 in [-1, 1]."""
    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:
        x = data.astype(np.float32)
    if x.ndim > 1:
        x = x.mean(axis=1)
    if sr != target_sr:
        g = np.gcd(sr, target_sr)
        x = resample_poly(x, target_sr // g, sr // g).astype(np.float32)
    return x


def save_wav(path: str | Path, x: np.ndarray, sr: int = 16000) -> None:
    """float32 [-1, 1] -> 16-bit WAV."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    x = np.clip(np.asarray(x).reshape(-1), -1.0, 1.0)
    wavfile.write(path, sr, (x * 32767.0).astype(np.int16))


def preprocess_split(
    wav_paths: list[str | Path],
    out_dir: str | Path,
    split: str,
    target_sr: int = 16000,
    clip_samples: int = 64000,
) -> np.ndarray:
    """Pack WAVs into ``<out_dir>/<split>.npy`` and a file manifest
    ``<split>_manifest.json``.

    Each file is decoded natively (RIFF parse and linear resample in
    ``native/audio_loader.cpp``); a file the native parser refuses (a
    format it does not read, such as 64-bit float) goes through scipy.
    Clips are padded or truncated to ``clip_samples`` (4 s @ 16 kHz, the
    fixed length of an NSynth note). Returns the packed array.
    """
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    packed = np.zeros((len(wav_paths), clip_samples), dtype=np.float32)
    names = []
    for i, p in enumerate(wav_paths):
        x = load_wav_native(p, max_samples=clip_samples, target_sr=target_sr)
        if x is None:
            x = load_wav(p, target_sr)
        x = x[:clip_samples]
        packed[i, : len(x)] = x
        names.append(Path(p).stem)
    np.save(out_dir / f"{split}.npy", packed)
    (out_dir / f"{split}_manifest.json").write_text(json.dumps(names))
    return packed


def load_split(out_dir: str | Path, split: str, mmap: bool = True) -> np.ndarray:
    return np.load(Path(out_dir) / f"{split}.npy", mmap_mode="r" if mmap else None)
