"""The port's spans and counters (``utils.profiling``): off without a
profiler, one entry per layer call under one, the tuner's numbers
unchanged by them, the set-up spans and ``trace()``'s ``spans.json``.
CPU only; no JAX."""

import json
import os
import stat
from unittest import mock

import pytest
import torch

from topo_audio_autoencoder_torch import cuda_build
from topo_audio_autoencoder_torch.models import AudioAutoencoder
from topo_audio_autoencoder_torch.ops import pqmf
from topo_audio_autoencoder_torch.training import (
    VmappedGridTuner,
    create_train_state,
    make_indexed_train_step,
    make_optimizer,
)
from topo_audio_autoencoder_torch.utils import profiling

torch.set_num_threads(1)

T = 2048  # the port refuses clips of 1,024 samples or fewer
B, G = 2, 3
TINY = dict(num_vertices=4, num_bands=4, sccn_hidden_dim=8, n_sccn_layers=1)
STEPS = 2
# Every span of a Gumbel train step (soft path, G >= 3, accumulation 1) and
# the span it sits in.
TRAIN_SPANS = {
    "taa.train.gather": None,
    "taa.train.step": None,
    "taa.train.cast": "taa.train.step",
    "taa.train.forward": "taa.train.step",
    "taa.train.backward": "taa.train.step",
    "taa.train.optimizer": "taa.train.step",
    "taa.optimizer.clip": "taa.train.optimizer",
    "taa.optimizer.adam": "taa.train.optimizer",
    "taa.pqmf.analysis": "taa.train.forward",
    "taa.encoder.logits": "taa.train.forward",
    "taa.loss.contrastive": "taa.train.forward",
    "taa.encoder.sample": "taa.train.forward",
    "taa.encoder.rectify": "taa.train.forward",
    "taa.decoder.sccn": "taa.train.forward",
    "taa.attention.fwd": "taa.train.forward",
    "taa.pqmf.synthesis": "taa.train.forward",
    "taa.loss.spectral": "taa.train.forward",
    "taa.attention.bwd": "taa.train.backward",
}
MAX_SPANS_PER_STEP = 25


def _train_steps():
    """``run(n)``: ``n`` indexed train steps of a tiny model, built (with
    its set-up spans) before the call."""
    model = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu", seed=3)
    corpus = torch.randn(8, T, generator=torch.Generator().manual_seed(5)) * 0.1
    optimizer = make_optimizer(accumulate_grad_batches=1)
    state = create_train_state(model, optimizer)
    step = make_indexed_train_step(model, optimizer, corpus)
    idx = torch.tensor([[0, 1, 2], [3, 4, 5]])

    def run(n: int = STEPS):
        for _ in range(n):
            step(state, idx, 1.0, 7)

    return run


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """Two train steps inside ``trace()``: its folder, the span summary and
    the Chrome trace's events."""
    folder = tmp_path_factory.mktemp("trace")
    run = _train_steps()
    with profiling.trace(str(folder)):
        run()
    summary = json.loads((folder / "spans.json").read_text())
    with open(folder / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return folder, summary, events


def test_off_records_nothing_and_never_annotates():
    """Outside a profiler a train step records no span and never enters
    ``record_function``; every span is one shared no-op context."""
    run = _train_steps()
    profiling.reset_spans()
    with mock.patch.object(torch.profiler, "record_function", side_effect=AssertionError("annotated")) as rf:
        run(1)
    assert rf.call_count == 0
    assert profiling.span_summary()["spans"] == {}
    assert profiling.span("taa.a") is profiling.span("taa.b")


@pytest.mark.parametrize("name,parent", sorted(TRAIN_SPANS.items()))
def test_train_span_once_a_step_in_its_parent(traced, name, parent):
    """Each train span is entered once a step, in the span the table names."""
    _, summary, _ = traced
    entry = summary["spans"][name]
    assert entry["count"] == STEPS
    assert entry["parent"] == parent
    assert 0.0 <= entry["self_host_s"] <= entry["host_s"]
    assert entry["device_s"] is None  # no CUDA here


def test_train_step_holds_no_other_span(traced):
    """No span opens inside a loop over leaves or layers: a step's entries
    are the table's, at most MAX_SPANS_PER_STEP."""
    _, summary, _ = traced
    spans = summary["spans"]
    assert set(spans) == set(TRAIN_SPANS)
    assert sum(e["count"] for e in spans.values()) / STEPS <= MAX_SPANS_PER_STEP


def test_children_cover_no_more_than_their_parent(traced):
    """Self time is the inclusive time less the children's cover."""
    _, summary, _ = traced
    spans = summary["spans"]
    step = spans["taa.train.step"]
    inside = sum(spans[n]["host_s"] for n, p in TRAIN_SPANS.items() if p == "taa.train.step")
    assert inside <= step["host_s"]
    assert step["self_host_s"] == pytest.approx(step["host_s"] - inside, abs=1e-6)


def test_trace_writes_spans_beside_the_chrome_trace(traced):
    """``trace()`` writes spans.json beside trace.json, whose
    ``user_annotation`` events carry the same names."""
    folder, summary, events = traced
    assert (folder / "trace.json").is_file() and (folder / "spans.json").is_file()
    annotations = {e["name"] for e in events if e.get("cat") == "user_annotation"}
    assert set(summary["spans"]) <= annotations
    assert summary["counters"] == {}


def test_trace_resets_the_records(traced):
    """A second ``trace()`` starts from no records."""
    with profiling.trace():
        with profiling.span("taa.test.only"):
            pass
    assert set(profiling.span_summary()["spans"]) == {"taa.test.only"}


def _grid_step(profiled: bool):
    model = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu", seed=3)
    tuner = VmappedGridTuner(model)
    state = tuner.init_grid({"encoder_lr": [1e-3, 5e-4], "decoder_lr": [1e-4], "complexity_penalty": [0.1]})
    batch = torch.randn(B, G, 1, T, generator=torch.Generator().manual_seed(11)) * 0.1
    profiling.reset_spans()
    if profiled:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            state, losses = tuner.grid_step(state, batch, 1.0, seed=9)
    else:
        state, losses = tuner.grid_step(state, batch, 1.0, seed=9)
    return losses, state.params, profiling.span_summary()["spans"]


@pytest.fixture(scope="module")
def grid():
    """One grid step without and one under the profiler."""
    return _grid_step(profiled=False), _grid_step(profiled=True)


@pytest.mark.parametrize("name", ["taa.pqmf.analysis", "taa.encoder.logits", "taa.decoder.sccn",
                                  "taa.attention.fwd", "taa.attention.bwd", "taa.loss.spectral"])
def test_vmapped_grid_step_records_spans_and_keeps_its_numbers(grid, name):
    """The tuner's grid step, whose model spans run under
    ``torch.func.vmap``, records them under the profiler and gives the same
    losses and parameters as without it."""
    (plain_losses, plain_params, plain_spans), (losses, params, spans) = grid
    assert plain_spans == {}
    assert spans[name]["count"] == 1
    assert torch.equal(losses, plain_losses)
    for n, p in params.items():
        assert torch.equal(p, plain_params[n]), n


def test_pqmf_design_recorded_once_per_design():
    """``taa.setup.pqmf_design`` is recorded once per (attenuation, bands),
    without a profiler."""
    pqmf._design_cached.cache_clear()
    profiling.reset_spans()
    for attenuation, bands in [(100.0, 4), (100.0, 4), (80.0, 4), (100.0, 8), (80.0, 4)]:
        pqmf.PQMF(attenuation, bands)
    spans = profiling.span_summary()["spans"]
    assert spans["taa.setup.pqmf_design"]["count"] == 3
    assert spans["taa.setup.pqmf_design"]["parent"] is None


def test_kernel_load_span_and_build_counter(tmp_path, monkeypatch):
    """Each first load of a library is ``taa.setup.kernel_load``, and
    ``kernel_builds`` counts the compiles: one for a missing library, none
    for one already built. A stand-in compiler writes an empty library."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do [ "$1" = "-o" ] && out=$2; shift; done\n'
                    'exec cc -shared -fPIC -x c /dev/null -o "$out"\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    profiling.reset_spans()
    load = cuda_build.load.__wrapped__  # around the per-process cache
    load("binary_gumbel")
    assert profiling.span_summary()["counters"] == {"kernel_builds": 1}
    load("binary_gumbel")
    summary = profiling.span_summary()
    assert summary["counters"] == {"kernel_builds": 1}
    assert summary["spans"]["taa.setup.kernel_load"]["count"] == 2
    assert os.listdir(tmp_path / "build") == [cuda_build.library_path("binary_gumbel").name]


@pytest.mark.parametrize("opener", [profiling.span, profiling.setup_span])
def test_span_names_carry_the_prefix(opener):
    """A span's name starts with ``taa.``."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(ValueError):
            opener("portbench.step")


def _span_on_another_thread(in_backward: bool) -> dict:
    """The spans of a worker thread that opens ``taa.inner`` while the
    caller waits inside ``taa.outer``. ``in_backward``: the worker runs a
    backward for autograd's engine, as its device threads do (which a CPU
    run cannot start, so the engine's task id is stood in for). A plain
    thread does not inherit the profiler's state, as autograd's threads
    do, so the worker opens a set-up span, which records without it."""
    import threading

    worker_ids = set()

    def work():
        worker_ids.add(threading.get_ident())
        with profiling.setup_span("taa.inner"):
            pass

    def task_id():
        return 0 if in_backward and threading.get_ident() in worker_ids else -1

    profiling.reset_spans()
    with mock.patch.object(profiling, "_graph_task_id", task_id):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            with profiling.span("taa.outer"):
                worker = threading.Thread(target=work)
                worker.start()
                worker.join()
    return profiling.span_summary()["spans"]


def test_backward_thread_span_takes_the_callers_span_as_parent():
    """A span opened on autograd's thread, while the caller waits inside a
    span, sits in the caller's innermost open span."""
    spans = _span_on_another_thread(in_backward=True)
    assert spans["taa.inner"]["parent"] == "taa.outer"
    assert spans["taa.outer"]["self_host_s"] < spans["taa.outer"]["host_s"]


def test_plain_thread_span_sits_in_no_other_threads_span():
    """A span opened on a thread that runs no backward is a root, whatever
    another thread has open."""
    spans = _span_on_another_thread(in_backward=False)
    assert spans["taa.inner"]["parent"] is None
    assert spans["taa.outer"]["self_host_s"] == spans["taa.outer"]["host_s"]


def test_records_keep_the_newest_spans():
    """Spans entered under a profiler keep the newest MAX_RECORDS; set-up
    spans are kept apart and stay."""
    extra = 10
    profiling.reset_spans()
    with profiling.setup_span("taa.setup.test"):
        pass
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiling.span("taa.test.old"):
            pass
        for _ in range(profiling.MAX_RECORDS - 1 + extra):
            with profiling.span("taa.test.new"):
                pass
    spans = profiling.span_summary()["spans"]
    assert "taa.test.old" not in spans
    assert spans["taa.test.new"]["count"] == profiling.MAX_RECORDS
    assert spans["taa.setup.test"]["count"] == 1


def test_concurrent_spans_lose_no_record():
    """Threads opening and closing spans at once (more threads than cores,
    a short switch interval) leave every record closed and counted, and no
    span open."""
    import sys
    import threading

    threads_n, spans_n = 2 * (os.cpu_count() or 1) + 2, 200

    def work():
        for _ in range(spans_n):
            with profiling.setup_span("taa.test.concurrent"):
                profiling.count("concurrent")

    profiling.reset_spans()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=work) for _ in range(threads_n)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(w.is_alive() for w in workers)
    summary = profiling.span_summary()
    assert summary["spans"]["taa.test.concurrent"]["count"] == threads_n * spans_n
    assert summary["counters"]["concurrent"] == threads_n * spans_n
    assert profiling._open == []
