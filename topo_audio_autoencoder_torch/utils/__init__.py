"""Utilities: profiling, debug instrumentation.

Port of ``topo_audio_autoencoder_tpu.utils``, with the same public names,
and the port's spans and counters (``span``, ``setup_span``, ``count``,
``span_summary``, ``reset_spans``)."""

from .debug import (
    assert_finite_tree,
    detect_anomalies,
    checked,
    finite_or_zero,
    golden_precision,
)
from .profiling import (
    chain_time,
    count,
    fetch_scalar,
    reset_spans,
    setup_span,
    span,
    span_summary,
    time_fn,
    trace,
    wait_for_backend,
)

__all__ = [
    "assert_finite_tree",
    "detect_anomalies",
    "checked",
    "finite_or_zero",
    "golden_precision",
    "chain_time",
    "fetch_scalar",
    "time_fn",
    "trace",
    "wait_for_backend",
    "span",
    "setup_span",
    "count",
    "span_summary",
    "reset_spans",
]
