"""The packed operators' spans and counter (``utils.profiling``):
``taa.packed.*`` once a call of each packed operator in a tiny packed train
step, none inside another, ``packed.builds`` once a step, the step's numbers
unchanged by them, and no span recorded without a profiler (the counter
counts every build, as the optimizer's counts every update). CPU only; no
JAX."""

from unittest import mock

import pytest
import torch

from topo_audio_autoencoder_torch.models import AudioAutoencoder
from topo_audio_autoencoder_torch.training import make_loss_and_grads
from topo_audio_autoencoder_torch.utils import profiling

torch.set_num_threads(1)

T = 2048  # the port refuses clips of 1,024 samples or fewer
LAYERS = 2
TINY = dict(num_vertices=6, num_bands=4, sccn_hidden_dim=8, n_sccn_layers=LAYERS, min_active_vertices=2,
            max_active_vertices=6, pack_capacities=(0, 0, 8, 6))  # 20 triangles, 15 tetrahedra
STEPS = 2
# Calls a step, by the code: one operator set; the two packed ranks'
# embeddings, forward and backward; in each SCCN layer down(2), down(3) and
# rank 3's down(3, up3) gather (each with its backward), and up(2), up(3),
# rank 1's up(2, down2) and gram_diag via rank 2, rank 2's up(3, down3) and
# gram_diag via rank 3 scatter.
PER_STEP = {
    "taa.packed.select": 1,
    "taa.packed.embed": 2,
    "taa.packed.embed_bwd": 2,
    "taa.packed.gather": 3 * LAYERS,
    "taa.packed.gather_bwd": 3 * LAYERS,
    "taa.packed.scatter": 6 * LAYERS,
}


def _steps():
    """``run(n)``: the loss and gradients of ``n`` steps of a tiny packed
    model, each a packed forward and backward."""
    model = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu", seed=3)
    loss_and_grads = make_loss_and_grads(model)
    batch = torch.randn(2, 3, 1, T, generator=torch.Generator().manual_seed(5)) * 0.1

    def run(n: int = STEPS):
        return [loss_and_grads(batch, 5.0, 7, step) for step in range(n)]

    return run


def _profiled(run, n: int = STEPS):
    profiling.reset_spans()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = run(n)
    return out, list(profiling._records), profiling.span_summary()


@pytest.fixture(scope="module")
def traced():
    """``STEPS`` steps off the profiler, then the same under it."""
    run = _steps()
    profiling.reset_spans()
    plain = run()
    off = profiling.span_summary()
    return plain, off, *_profiled(run)


@pytest.mark.parametrize("name,count", sorted(PER_STEP.items()))
def test_packed_span_once_a_call(traced, name, count):
    _, _, _, _, summary = traced
    entry = summary["spans"][name]
    assert entry["count"] == count * STEPS
    assert 0.0 <= entry["self_host_s"] <= entry["host_s"]
    assert entry["device_s"] is None  # no CUDA here


def test_packed_spans_are_the_tables(traced):
    _, _, _, _, summary = traced
    assert {n for n in summary["spans"] if n.startswith("taa.packed.")} == set(PER_STEP)


def test_no_packed_span_inside_another(traced):
    """Their sum counts each interval once: no ``taa.packed.*`` record sits
    in another, and none overlaps another on the host clock."""
    _, _, _, records, _ = traced
    mine = sorted((r for r in records if r.name.startswith("taa.packed.")), key=lambda r: r.start_ns)
    assert len(mine) == sum(PER_STEP.values()) * STEPS
    for rec in mine:
        parent = rec.parent
        while parent is not None:
            assert not parent.name.startswith("taa.packed."), (rec.name, parent.name)
            parent = parent.parent
    for a, b in zip(mine, mine[1:]):
        assert a.end_ns <= b.start_ns, (a.name, b.name)


def test_builds_counted_once_a_step(traced):
    _, _, _, _, summary = traced
    assert summary["counters"] == {"packed.builds": STEPS}


def test_off_records_no_span(traced):
    """Without a profiler: no span and no ``record_function``; the counter
    counts the builds."""
    _, off, _, _, _ = traced
    assert off == {"spans": {}, "counters": {"packed.builds": STEPS}}
    run = _steps()
    profiling.reset_spans()
    with mock.patch.object(torch.profiler, "record_function", side_effect=AssertionError("annotated")) as rf:
        run(1)
    assert rf.call_count == 0
    assert profiling.span_summary() == {"spans": {}, "counters": {"packed.builds": 1}}


def test_spans_change_no_number(traced):
    """The steps' losses, components and gradients, bit for bit, with the
    spans on and off."""
    plain, _, profiled, _, _ = traced
    for (total, parts, grads), (p_total, p_parts, p_grads) in zip(plain, profiled):
        assert torch.equal(total, p_total)
        assert all(torch.equal(v, p_parts[k]) for k, v in parts.items())
        assert set(grads) == set(p_grads)
        for name, g in grads.items():
            assert torch.equal(g, p_grads[name]), name
