"""Profiling and step-timing utilities.

Port of ``topo_audio_autoencoder_tpu.utils.profiling``. The reference
imports torch.profiler but never invokes it (SURVEY §5.1). Here:
``torch.profiler`` trace capture (the card's activity when a card is
present) written as a Chrome trace, and step timers whose completion is
forced by a one-element read, timed with CUDA events when the work runs
on the card.

Spans and counters name the port's layers from the inside. ``span(name)``
marks one call of a layer (``taa.train.forward``, ``taa.attention.fwd``,
...); it is off, one shared no-op context, unless a ``torch.profiler``
session is active. While one is, a span enters
``torch.profiler.record_function(name)``, so the layer's name lies in the
same trace as its kernels, and records its host interval
(``perf_counter_ns``) and its parent span; a span opened with
``device=True`` (the attention layer's two) also records a pair of CUDA
events on the current stream once CUDA is initialised. The records keep
the newest MAX_RECORDS spans.
``setup_span(name)`` records set-up work (the PQMF design, the kernels'
load) whether or not a profiler runs, in records of its own.
``count(name, n)`` adds to a named counter. ``span_summary()`` sums the
records by name and ``reset_spans()`` clears them; ``trace()`` resets them
on entry and writes the summary as ``spans.json`` beside ``trace.json``.
No span opens inside a loop over parameter leaves: a dense train step
holds about 20, a packed one also a ``taa.packed.*`` span for each packed
product of every SCCN layer (about 80 at 6 layers).
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter, deque
from pathlib import Path

import numpy as np
import torch
import torch.utils._pytree as pytree


SPAN_PREFIX = "taa."
MAX_RECORDS = 4096  # about 200 train steps of spans

# Whether a torch.profiler session is active on this thread (autograd's
# threads inherit the caller's profiler state).
_profiler_enabled = torch._C._autograd._profiler_enabled
# The id of the backward this thread runs for autograd's engine, -1 outside one.
_graph_task_id = torch._C._current_graph_task_id
_OFF = contextlib.nullcontext()
_lock = threading.Lock()  # guards the records, the open spans and the counters
_records: deque = deque(maxlen=MAX_RECORDS)  # the newest spans entered under a profiler, in entry order
_setup_records: list = []  # the set-up spans since the last reset
_counters: Counter = Counter()
_open: list = []  # the spans open now, over every thread, in entry order
_local = threading.local()  # .stack: this thread's open spans


class _Record:
    __slots__ = ("name", "parent", "start_ns", "end_ns", "events")

    def __init__(self, name: str):
        self.name, self.parent, self.start_ns, self.end_ns, self.events = name, None, 0, None, None


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """One entry of a layer: the annotation (``annotate``), the host
    interval and, with ``device``, a CUDA event pair on the current stream;
    kept in ``records``."""

    __slots__ = ("record", "annotation", "device", "records")

    def __init__(self, name: str, annotate: bool, device: bool, records):
        if not name.startswith(SPAN_PREFIX):
            raise ValueError(f"span names start with {SPAN_PREFIX!r}, not {name!r}")
        self.record = _Record(name)
        self.annotation = torch.profiler.record_function(name) if annotate else None
        self.device, self.records = device, records

    def __enter__(self):
        rec, stack = self.record, _stack()
        with _lock:
            if stack:
                rec.parent = stack[-1]
            elif _open and _graph_task_id() >= 0:
                # A backward on autograd's own thread sits in the innermost
                # span open on any thread: the caller's, blocked in it.
                rec.parent = _open[-1]
            _open.append(rec)
            self.records.append(rec)
        stack.append(rec)
        if self.annotation is not None:
            self.annotation.__enter__()
        if self.device:
            rec.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            rec.events[0].record()
        rec.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.record
        rec.end_ns = time.perf_counter_ns()
        if rec.events is not None:
            rec.events[1].record()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        _stack().remove(rec)
        with _lock:
            _open.remove(rec)
        return False


def span(name: str, *, device: bool = False):
    """A context marking one call of a layer. Off (one shared no-op
    context, no ``record_function``) unless a ``torch.profiler`` session is
    active; while one is, it annotates the trace and records the span,
    with ``device`` its CUDA event pair too."""
    if not _profiler_enabled():
        return _OFF
    return _Span(name, annotate=True, device=device and torch.cuda.is_initialized(), records=_records)


def setup_span(name: str):
    """A span for set-up work, recorded whether or not a profiler is
    active (annotated only while one is). It takes no device events."""
    return _Span(name, annotate=_profiler_enabled(), device=False, records=_setup_records)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counters[name] += n


def reset_spans() -> None:
    """Clear the recorded spans and the counters."""
    with _lock:
        _records.clear()
        _setup_records.clear()
        _counters.clear()


def _covered_ns(rec, children) -> int:
    """Nanoseconds of ``rec``'s interval that its children's intervals
    cover (their union, clipped to it)."""
    covered, reach = 0, rec.start_ns
    for start, end in sorted((max(c.start_ns, rec.start_ns), min(c.end_ns, rec.end_ns)) for c in children):
        start = max(start, reach)
        if end > start:
            covered += end - start
            reach = end
    return covered


def span_summary() -> dict:
    """``{"spans": {name: {count, host_s, self_host_s, device_s, parent}},
    "counters": {name: n}}`` over the closed spans recorded since the last
    reset (of those entered under a profiler, the newest MAX_RECORDS).
    ``host_s`` is inclusive; ``self_host_s`` leaves out the time the span's
    children cover; ``device_s`` sums the CUDA event pairs (waiting for
    them) and is None where no span of the name had events; ``parent`` is
    the name most of its spans sat in (None at the root)."""
    with _lock:
        closed = [r for r in (*_setup_records, *_records) if r.end_ns is not None]
        counters = dict(_counters)
    children: dict = {}
    for rec in closed:
        if rec.parent is not None:
            children.setdefault(id(rec.parent), []).append(rec)
    spans: dict = {}
    parents: dict = {}
    for rec in closed:
        entry = spans.setdefault(rec.name, {"count": 0, "host_s": 0.0, "self_host_s": 0.0, "device_s": None})
        inclusive = rec.end_ns - rec.start_ns
        entry["count"] += 1
        entry["host_s"] += inclusive * 1e-9
        entry["self_host_s"] += (inclusive - _covered_ns(rec, children.get(id(rec), ()))) * 1e-9
        if rec.events is not None:
            start, end = rec.events
            end.synchronize()
            entry["device_s"] = (entry["device_s"] or 0.0) + start.elapsed_time(end) * 1e-3
        parents.setdefault(rec.name, Counter())[rec.parent.name if rec.parent is not None else None] += 1
    for name, entry in spans.items():
        entry["parent"] = parents[name].most_common(1)[0][0]
    return {"spans": spans, "counters": counters}


@contextlib.contextmanager
def trace(log_dir: str | None = None):
    """Capture a torch.profiler trace (CPU, and CUDA when a card is
    present) and write it to ``<log_dir>/trace.json`` (Chrome trace format,
    viewable in Perfetto) on exit, with the spans recorded inside
    (``span_summary``) as ``<log_dir>/spans.json``. The span records are
    reset on entry. ``log_dir`` defaults to a new temporary directory;
    yields it."""
    from torch.profiler import ProfilerActivity, profile

    log_dir = Path(log_dir) if log_dir is not None else Path(tempfile.mkdtemp(prefix="torch_trace_"))
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset_spans()
    with profile(activities=activities) as prof:
        yield str(log_dir)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))
    (log_dir / "spans.json").write_text(json.dumps(span_summary(), indent=1, sort_keys=True))


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
