"""The arithmetic the per-layer metric files share. Each returns None when
the run has nothing to read (no trace, no matching kernel), and the
harness then leaves the metric out."""

from __future__ import annotations

import statistics

from . import counts, trace


def mean_span_ms(run, field: int | None = None):
    """Mean host milliseconds of the window's unprofiled calls (``field``:
    one part of a call's spans)."""
    spans = [s if field is None else s[field] for s in run.spans]
    return statistics.fmean(spans) * 1e3 if spans else None


def idle_share(run):
    """100 x (1 - busy / window) over the profiled calls."""
    s = run.summary
    if not s.get("window_s") or not s.get("device_ops"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def launches_per_call(run):
    s = run.summary
    if not s.get("kernels"):
        return None
    return len(s["kernels"]) / s["calls"]


def roofline_share(run, which: str, kernel_names, peak: str):
    """100 x the least time of the call's ``which`` attention work over the
    profiled time of its kernels, a call."""
    seconds, launches = trace.kernel_seconds(run.summary, kernel_names)
    if not launches or which not in run.attention:
        return None
    flops, nbytes = run.attention[which]
    bound, _ = counts.roofline_seconds(flops, nbytes, peak)
    return 100.0 * bound / (seconds / run.summary["calls"])


def mfu(run):
    """100 x the model FLOPs a call over the window's time a call, over the
    configuration's peak."""
    if not run.units:
        return None
    return 100.0 * run.flops_per_unit / (run.window_s / run.units) / counts.PEAK_FLOPS[run.peak]
