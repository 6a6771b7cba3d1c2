"""Profiling and step-timing utilities.

Port of ``topo_audio_autoencoder_tpu.utils.profiling``. The reference
imports torch.profiler but never invokes it (SURVEY §5.1). Here:
``torch.profiler`` trace capture (the card's activity when a card is
present) written as a Chrome trace, and step timers whose completion is
forced by a one-element read, timed with CUDA events when the work runs
on the card.
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.utils._pytree as pytree


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a torch.profiler trace (CPU, and CUDA when a card is
    present) and write it to ``<log_dir>/trace.json`` (Chrome trace format,
    viewable in Perfetto) on exit. ``log_dir`` defaults to a new temporary
    directory; yields it."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir) if log_dir is not None else Path(tempfile.mkdtemp(prefix="torch_trace_"))
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield str(log_dir)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _tensors(out) -> list:
    return [t for t in pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]


def fetch_scalar(out) -> float:
    """Force TRUE completion of ``out`` by reading one element of its
    smallest tensor to the host with ``.item()``: the read needs the bytes,
    so it cannot return before the work that writes them."""
    leaves = [t for t in _tensors(out) if t.numel() > 0]
    smallest = min(leaves, key=lambda t: t.numel())
    return float(smallest.reshape(-1)[:1].item())


def _on_card(out) -> bool:
    return any(t.is_cuda for t in _tensors(out))


def time_fn(fn, *args, warmup: int = 2, iters: int = 10, **kwargs) -> dict:
    """Per-call time of ``fn(*args, **kwargs)``, after ``warmup`` calls.

    Where the output lies on the card, each call is timed by two CUDA
    events recorded on the current stream around it, read after the call's
    end (the device's time from the first launch to the last). Otherwise
    the host clock, with completion forced by ``fetch_scalar``: per-call
    times then include that read. Returns {'p50', 'mean', 'min', 'max'} in
    seconds per call."""
    out = None
    for _ in range(warmup):
        out = fn(*args, **kwargs)
        fetch_scalar(out)
    times = []
    for _ in range(iters):
        if out is not None and _on_card(out):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            fetch_scalar(out)
            times.append(time.perf_counter() - t0)
    times = np.asarray(times)
    return {
        "p50": float(np.median(times)),
        "mean": float(times.mean()),
        "min": float(times.min()),
        "max": float(times.max()),
    }


def chain_time(make_step, k1: int = 5, k2: int = 25, warmup: int = 3) -> float:
    """Per-call time via a chain-length slope.

    ``make_step()`` returns a ``step(i) -> out`` closure whose calls are
    SEQUENTIALLY DEPENDENT (each consumes the previous output/state). Two
    chain lengths are run, each ended by ``fetch_scalar`` (on the card,
    timed by CUDA events around the chain); the slope (T2 - T1) / (k2 - k1)
    cancels the fixed launch and read cost."""
    step = make_step()
    out = None
    for i in range(warmup):
        out = step(i)
    if out is not None:  # warmup=0: nothing in flight to drain
        fetch_scalar(out)
    card = out is not None and _on_card(out)

    def run(k):
        step = make_step()
        if card:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = None
        for i in range(k):
            out = step(i)
        if card:
            end.record()
            fetch_scalar(out)
            return start.elapsed_time(end) / 1e3
        fetch_scalar(out)
        return time.perf_counter() - t0

    t1 = run(k1)
    t2 = run(k2)
    return max((t2 - t1) / (k2 - k1), 1e-9)


_PROBES = {
    "cuda": "import torch; torch.cuda.init(); assert torch.cuda.device_count() > 0",
    "cpu": "import torch",
}


def wait_for_backend(
    max_wait: float,
    *,
    platform: str | None = None,
    poll: float = 30.0,
    probe_timeout: float = 120.0,
    log=None,
) -> bool:
    """Wait out a transient accelerator outage; True if reachable.

    Probing runs ``torch.cuda.init(); torch.cuda.device_count()`` (platform
    None or "cuda") or ``import torch`` ("cpu") in a SUBPROCESS, so that a
    hung initialisation can be timed out without poisoning the calling
    process's CUDA state; once a probe succeeds, the caller's own
    initialisation finds a live device. Any other platform name fails every
    probe."""
    code = _PROBES.get(platform or "cuda", f"raise SystemExit('unknown platform {platform!r}')")
    deadline = time.time() + max_wait
    attempt = 0
    while True:
        attempt += 1
        budget = deadline - time.time()
        if budget <= 0:
            break
        try:
            proc = subprocess.run(
                [sys.executable, "-c", code],
                capture_output=True,
                timeout=min(probe_timeout, max(10.0, budget)),
            )
            if proc.returncode == 0:
                if log and attempt > 1:
                    log(f"backend reachable (probe attempt {attempt})")
                return True
            if log:
                log(f"backend probe {attempt} failed (rc={proc.returncode})")
        except subprocess.TimeoutExpired:
            if log:
                log(f"backend probe {attempt} timed out")
        time.sleep(min(poll, max(0.0, deadline - time.time())))
    if log:
        log(f"backend still unreachable after {max_wait:.0f}s")
    return False
