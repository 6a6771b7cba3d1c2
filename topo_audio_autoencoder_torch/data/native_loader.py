"""ctypes bindings for the native (C++) host audio runtime.

Wraps ``native/audio_loader.cpp``: WAV decode (RIFF parse, mono mix, linear
resample) and the multithreaded contrastive batch assembly. The source is
compiled with ``g++`` on first use into ``_build/libtaa_audio-<digest>.so``,
where the digest covers the source and the flags, so an edited source is
never served from a stale build (as ``cuda_build.py`` does for the CUDA
kernels). The flags hold no ``-march=native``: the library runs on any
x86-64 host. A failed build raises with the compiler's output; nothing
falls back quietly to NumPy. The NumPy versions (``_assemble_numpy``,
``_gather_numpy``) are the plain versions the tests compare against, and
callers that want them call them by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

from ..cuda_build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "native" / "audio_loader.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-shared", "-pthread")


def library_path(source: Path = SOURCE) -> Path:
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libtaa_audio-{digest.hexdigest()[:12]}.so"


def build(source: Path = SOURCE) -> Path:
    """Compile ``source`` into its ``_build/`` library unless it is there;
    raises with the compiler's output if the compile fails."""
    target = library_path(source)
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(
            f"native audio runtime build failed ({' '.join(cmd)} exited "
            f"{proc.returncode}):\n{proc.stderr}"
        )
    os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
    return target


@lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The loaded native library, built first if missing."""
    lib = ctypes.CDLL(str(build()))
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.taa_load_wav.restype = ctypes.c_int
    lib.taa_load_wav.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int, ctypes.c_int]
    lib.taa_assemble_contrastive_batch.restype = None
    lib.taa_assemble_contrastive_batch.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, i32p, ctypes.c_int, i32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, f32p, ctypes.c_int,
    ]
    lib.taa_gather_batch.restype = None
    lib.taa_gather_batch.argtypes = [f32p, ctypes.c_int, i32p, ctypes.c_int, f32p]
    return lib


def native_available() -> bool:
    """Whether the native library loads (built first if missing); never
    raises."""
    try:
        get_lib()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return False
    return True


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _check_rows(idxs: np.ndarray, n: int) -> None:
    if len(idxs) and (idxs.min() < 0 or idxs.max() >= n):
        raise IndexError(f"row index out of range for a corpus of {n} rows")


def load_wav_native(
    path: str | Path, max_samples: int = 16000 * 30, target_sr: int = 16000
) -> np.ndarray | None:
    """Decode and resample a WAV natively; None if the parser refuses the
    file (the caller decodes it with scipy instead)."""
    out = np.zeros(max_samples, dtype=np.float32)
    n = get_lib().taa_load_wav(str(path).encode(), _f32p(out), max_samples, target_sr)
    if n < 0:
        return None
    return out[:n].copy()


def assemble_contrastive_batch(
    corpus: np.ndarray,  # [N, T] float32
    anchors: np.ndarray,  # [B] int32
    neighbors: np.ndarray,  # [N, N-1] int32
    num_pos: int,
    num_neg: int,
    neg_end: int,
    seed: int,
    num_threads: int | None = None,
) -> np.ndarray:
    """[B, 2+num_neg, T] contrastive stacks, with the library's own
    xorshift stream for the positives."""
    corpus = np.ascontiguousarray(corpus, dtype=np.float32)
    anchors = np.ascontiguousarray(anchors, dtype=np.int32)
    neighbors = np.ascontiguousarray(neighbors, dtype=np.int32)
    n, t = corpus.shape
    _check_rows(anchors, n)
    _check_rows(neighbors.reshape(-1), n)
    if neighbors.shape[0] != n or neighbors.shape[1] < 1 or num_pos < 1:
        raise ValueError(
            f"need [N={n}, >= 1] neighbors and num_pos >= 1, not {neighbors.shape} and {num_pos}"
        )
    b = len(anchors)
    out = np.empty((b, 2 + num_neg, t), dtype=np.float32)
    if num_threads is None:
        num_threads = min(8, os.cpu_count() or 1)
    get_lib().taa_assemble_contrastive_batch(
        _f32p(corpus), n, t, _i32p(anchors), b, _i32p(neighbors),
        neighbors.shape[1], num_pos, num_neg, neg_end,
        ctypes.c_uint64(seed), _f32p(out), num_threads,
    )
    return out


def _assemble_numpy(corpus, anchors, neighbors, num_pos, num_neg, neg_end, seed) -> np.ndarray:
    """Plain version with the same window semantics (its RNG differs)."""
    n_nb = neighbors.shape[1]
    neg_end = min(neg_end, n_nb)
    neg_start = max(0, neg_end - num_neg)
    rng = np.random.default_rng(seed)
    rows = []
    for a in anchors:
        pos = neighbors[a, rng.integers(0, min(num_pos, n_nb))]
        negs = neighbors[a, neg_start:neg_end]
        if len(negs) < num_neg:
            negs = np.pad(negs, (0, num_neg - len(negs)), mode="edge")
        rows.append(corpus[np.concatenate([[a, pos], negs])])
    return np.stack(rows)


def gather_batch(corpus: np.ndarray, idxs: np.ndarray) -> np.ndarray:
    """[len(idxs), T]: the corpus rows ``idxs``, copied natively."""
    corpus = np.ascontiguousarray(corpus, dtype=np.float32)
    idxs = np.ascontiguousarray(idxs, dtype=np.int32)
    _check_rows(idxs, len(corpus))
    out = np.empty((len(idxs), corpus.shape[1]), dtype=np.float32)
    get_lib().taa_gather_batch(_f32p(corpus), corpus.shape[1], _i32p(idxs), len(idxs), _f32p(out))
    return out


def _gather_numpy(corpus: np.ndarray, idxs: np.ndarray) -> np.ndarray:
    """Plain version of ``gather_batch``."""
    return np.asarray(corpus, dtype=np.float32)[np.asarray(idxs)].copy()
