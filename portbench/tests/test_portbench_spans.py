"""The per-layer metrics that read the port's spans (``portbench/spans.py``)
in a tiny traced CPU run, and the trace summary's gap labels under the
port's span names."""

import time

import pytest
import torch

from portbench import harness, trace
from portbench.tests import tiny

HOST = ("forward_host_ms.train", "backward_host_ms.train", "optimizer_host_ms.train", "loss_host_ms.train")
SETUP = ("pqmf_design_s.setup", "kernel_load_s.setup")
SPAN_ROOFLINES = ("attention_fwd_span_roofline.train", "attention_bwd_span_roofline.train")


@pytest.fixture(scope="module")
def traced_run():
    """A tiny traced run of the train cell in a process whose PQMF design
    and span records start empty, as a run's own process does."""
    from topo_audio_autoencoder_torch.ops import pqmf
    from topo_audio_autoencoder_torch.utils import profiling

    pqmf._design_cached.cache_clear()
    profiling.reset_spans()
    entry, cfg, traffic, spec = tiny.cell(tiny.TRAIN)
    # The profile is taken once half the window has passed, so the window
    # must hold several steps on a CPU shared with other test workers: one
    # intra-op thread (no oversubscribed thread pool) and a window of 6 s.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return harness.run_cell(torch, "cpu", tiny.BENCH, entry, cfg, traffic, spec,
                                tiny.args(trace=1, seconds=6.0), time.perf_counter())
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("name", HOST)
def test_traced_run_reports_host_span_metrics(traced_run, name):
    metric = traced_run["metrics"][name]
    assert metric["unit"] == "ms" and metric["value"] > 0.0


def test_host_span_metrics_fit_in_the_step(traced_run):
    """Forward, backward and optimizer are disjoint parts of the step; the
    losses lie inside the forward."""
    m = {name: traced_run["metrics"][name]["value"] for name in HOST}
    assert m["loss_host_ms.train"] < m["forward_host_ms.train"]
    from topo_audio_autoencoder_torch.utils import profiling

    spans = profiling.span_summary()["spans"]
    step_ms = 1e3 * spans["taa.train.step"]["host_s"] / spans["taa.train.step"]["count"]
    assert m["forward_host_ms.train"] + m["backward_host_ms.train"] + m["optimizer_host_ms.train"] <= step_ms


@pytest.mark.parametrize("name", SETUP)
def test_traced_run_reports_setup_span_metrics(traced_run, name):
    """The PQMF design ran in this process's set-up; no kernel library
    loads on the CPU, which reads 0."""
    metric = traced_run["metrics"][name]
    assert metric["unit"] == "s"
    assert (metric["value"] > 0.0) == (name == "pqmf_design_s.setup")


@pytest.mark.parametrize("name", SPAN_ROOFLINES)
def test_span_rooflines_absent_without_cuda(traced_run, name):
    assert name not in traced_run["metrics"]


def test_port_without_recorder_reads_nothing(monkeypatch):
    """A port without the recorder (a parent commit) gives no value and no
    error."""
    from portbench import spans
    from topo_audio_autoencoder_torch.utils import profiling

    monkeypatch.delattr(profiling, "span_summary")
    assert spans.host_ms_per_step("taa.train.forward") is None
    assert spans.setup_seconds("taa.setup.pqmf_design") is None


def test_idle_gap_takes_the_port_span_name():
    """``trace.summarize`` labels an idle gap by the innermost host op at
    its middle: a port span over the gap names it, not the benchmark's
    annotation around the step."""
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.step", "ts": 0.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "taa.train.optimizer", "ts": 300.0, "dur": 500.0},
        {"ph": "X", "cat": "kernel", "name": "k0", "ts": 0.0, "dur": 300.0},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 800.0, "dur": 200.0},
    ]
    summary = trace.summarize(events, 1)
    assert summary["top_idle_gaps"] == [("taa.train.optimizer", pytest.approx(500e-6))]
    assert summary["busy_s"] == pytest.approx(500e-6)
