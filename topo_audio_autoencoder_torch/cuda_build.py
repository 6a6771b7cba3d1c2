"""Build and load the hand-written CUDA kernels in ``csrc/``.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``_build/lib<name>-<digest>.so``,
where the digest covers the source, every shared header ``csrc/*.cuh`` and
the flags, so an edited source or header is never served from a stale
build. The library is loaded with ``ctypes``.
Nothing is built when the package is imported: ``load`` builds on first
use, and ``build`` compiles several sources at once, one ``nvcc`` process
each, all started together. Each first ``load`` of a library is the set-up
span ``taa.setup.kernel_load`` (``utils.profiling``), its build included;
the counter ``kernel_builds`` counts the sources ``build`` compiles.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from functools import lru_cache
from pathlib import Path

from .utils.profiling import count, setup_span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
KERNELS = (
    "masked_attention_fwd", "masked_attention_bwd", "binary_gumbel", "hard_concrete", "sccn_combine",
    "multi_tensor_adam", "pqmf_synthesis",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
            "PATH): the CUDA kernels cannot be built"
        )
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def build(names=KERNELS) -> dict:
    """Compile every named source whose library is missing, in parallel.

    Returns ``{name: {"seconds": wall time, "ptxas": compiler report}}``
    for the sources it compiled; raises if any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs[name] = (proc, tmp, target)
    count("kernel_builds", len(jobs))
    report = {}
    failures = []
    for name, (proc, tmp, target) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent build never sees half a file
        report[name] = {"seconds": time.perf_counter() - t0, "ptxas": log.strip()}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return report


@lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if missing."""
    with setup_span("taa.setup.kernel_load"):
        path = library_path(name)
        if not path.exists():
            build((name,))
        return ctypes.CDLL(str(path))
