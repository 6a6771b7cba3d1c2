"""The profiler window of a ``--trace 1`` run and what is read from it.

A few steady steps or requests inside the measured window run under
``torch.profiler`` (CPU and CUDA activities), each inside a
``record_function`` named ``portbench.<what>``, padded by PROFILE_PAD_S of
host sleep on both sides: the profiler drops device events whose
timestamps fall outside its window, and device and host clocks were seen
to sit milliseconds apart. The Chrome trace goes to a temporary directory
under ``TMPDIR`` and is deleted once read.
"""

from __future__ import annotations

import heapq
import json
import shutil
import tempfile
import time
from pathlib import Path

PROFILE_PAD_S = 0.02
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
ANNOTATION = "portbench."


def profile(torch, fn, count: int, what: str, device="cuda") -> dict:
    """Run ``fn()`` ``count`` times under the profiler and return the
    summary of ``summarize``."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    cuda = device != "cpu"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with torch_profile(activities=activities) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(count):
            with record_function(ANNOTATION + what):
                fn()
        if cuda:
            torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    folder = Path(tempfile.mkdtemp(prefix="portbench_trace_"))
    try:
        path = folder / "trace.json"
        prof.export_chrome_trace(str(path))
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    return summarize(events, count)


def _union(intervals) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def summarize(events: list, count: int) -> dict:
    """From Chrome trace events (``ts``/``dur`` in microseconds): the
    window (from the first annotated call's start to the last device op's
    end), the device's busy seconds in it (the union of its ops'
    intervals), the kernels, and the idle gaps labelled by the innermost
    host op running at each gap's middle."""
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    calls = [e for e in spans if e.get("cat") == "user_annotation" and e["name"].startswith(ANNOTATION)]
    device = [e for e in spans if e.get("cat") in DEVICE_CATS]
    if not calls or not device:
        return {"calls": count, "device_ops": 0}
    start = min(e["ts"] for e in calls)
    end = max(max(e["ts"] + e["dur"] for e in device), max(e["ts"] + e["dur"] for e in calls))
    busy = _union((max(e["ts"], start), min(e["ts"] + e["dur"], end)) for e in device
                  if e["ts"] + e["dur"] > start and e["ts"] < end)
    busy_us = sum(b - a for a, b in busy)
    kernels = [(e["name"], e["dur"] * 1e-6) for e in device if e.get("cat") == "kernel"]
    by_name: dict = {}
    for name, sec in ((e["name"], e["dur"] * 1e-6) for e in device):
        by_name[name] = by_name.get(name, 0.0) + sec
    host = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in spans if e.get("cat") in HOST_CATS)
    gaps: dict = {}
    open_ops: list = []  # max-heap on start of the host ops begun so far
    j = 0
    edges = [start] + [x for pair in busy for x in pair] + [end]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        while j < len(host) and host[j][0] <= mid:
            heapq.heappush(open_ops, (-host[j][0], host[j][1], host[j][2]))
            j += 1
        while open_ops and open_ops[0][1] < mid:  # ended: gap middles only grow
            heapq.heappop(open_ops)
        # The latest-starting host op still running is the innermost one.
        label = open_ops[0][2] if open_ops else "no host op"
        gaps[label] = gaps.get(label, 0.0) + (b - a) * 1e-6
    return {
        "calls": count,
        "window_s": (end - start) * 1e-6,
        "busy_s": busy_us * 1e-6,
        "device_ops": len(device),
        "kernels": kernels,
        "top_device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "top_idle_gaps": sorted(gaps.items(), key=lambda kv: -kv[1])[:10],
    }


def kernel_seconds(summary: dict, names) -> tuple:
    """(seconds, launches) of the kernels whose name contains any of
    ``names``."""
    hits = [sec for name, sec in summary.get("kernels", ()) if any(n in name for n in names)]
    return sum(hits), len(hits)
