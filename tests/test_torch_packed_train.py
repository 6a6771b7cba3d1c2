"""The port's packed train step (n=32's model with ranks 2-3 packed, cut to
``portbench.tests.tiny``'s size: n=10, caps (0, 0, 60, 40), so both packed
ranks truncate, fp32) against the plain reference (``portbench/reference/``):
loss, gradients and kept rows on seeded weights, and the benchmark cell
``packed_n32.train_b128`` correct when sound and not correct under the
planted faults of the packed operators and under its control. CPU only; no
JAX.

The cell runs the ``train_directions`` kind (``portbench/kinds/``): the
``train`` kind's check and ``grad_turned_share_large``, the share of large
leaves whose first gradient turned by more than 45 degrees. The norms alone
do not see a ``_FaceSum`` backward returning zeros on the card (PERF.md);
the angle does, here and there.

``plant_packed`` plants the packed faults by ``unittest.mock``, beside the
faults of ``portbench/faults.py``; a script calibrating the cell's limits on
the card imports it from here.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

from portbench import common, harness, inputs
from portbench.kinds import train_directions
from portbench.reference import encoder as ref_encoder
from portbench.reference import train as ref_train
from portbench.tests import tiny

CELL = "packed_n32.train_b128"
SEED = 2**31 + 17
PACKED_FAULTS = ("face_sum_bwd_zero", "row_gather_bwd_zero", "select_first_k")


def tiny_cell():
    """(entry, cfg, traffic, spec) of the cell at ``tiny``'s size, which
    cuts a mix by its kind: this one is a ``train`` mix with a further
    number in its check."""
    entry, cfg, traffic, spec = harness.cell_files(tiny.BENCH, CELL)
    cfg, small, spec = tiny.shrink(cfg, {**traffic, "kind": "train"}, spec)
    return entry, cfg, {**small, "kind": traffic["kind"]}, spec


@contextlib.contextmanager
def plant_packed(name: str):
    """Inside, the port runs with packed fault ``name``:
    ``face_sum_bwd_zero``, ``_FaceSum``'s backward returns zeros;
    ``row_gather_bwd_zero``, ``_RowGather``'s backward returns zeros;
    ``select_first_k``, each packed rank keeps its first K rows by index
    instead of the top K by key."""
    from topo_audio_autoencoder_torch.models import encoder
    from topo_audio_autoencoder_torch.topology import packed

    if name == "face_sum_bwd_zero":
        def face_sum_zero(ctx, g):
            (onehot,) = ctx.saved_tensors
            return g.new_zeros((*onehot.shape[:-1], g.shape[-1])), None, None, None

        patch = mock.patch.object(packed._FaceSum, "backward", staticmethod(face_sum_zero))
    elif name == "row_gather_bwd_zero":
        def row_gather_zero(ctx, g):
            return g.new_zeros((ctx.rows, g.shape[-1])), None

        patch = mock.patch.object(encoder._RowGather, "backward", staticmethod(row_gather_zero))
    elif name == "select_first_k":
        build = packed.build_packed_operators

        def first_k(probs, tables, capacities, masks=None, select_key=None):
            key = tuple(-torch.arange(p.shape[-1], device=p.device, dtype=torch.float32).expand(p.shape)
                        for p in probs.ranks)
            return build(probs, tables, capacities, masks=masks, select_key=key)

        patch = mock.patch.object(encoder, "build_packed_operators", first_k)
    else:
        raise ValueError(f"no packed fault {name!r}; one of {PACKED_FAULTS}")
    with patch:
        yield


@contextlib.contextmanager
def kept_rows(module):
    """Records the ``idx`` of every operator set ``module``'s
    ``build_packed_operators`` builds inside."""
    build = module.build_packed_operators
    seen: list = []

    def recording(*args, **kwargs):
        ops = build(*args, **kwargs)
        seen.append(ops.idx)
        return ops

    with mock.patch.object(module, "build_packed_operators", recording):
        yield seen


def rel_l2(a: dict, b: dict) -> float:
    num = sum(float(torch.sum((a[n] - b[n]) ** 2)) for n in b)
    return (num / sum(float(torch.sum(b[n] ** 2)) for n in b)) ** 0.5


@pytest.fixture(scope="module")
def step_pair():
    """One packed step of the port (``make_loss_and_grads``) and of the
    reference from the same seeded weights and batch, with the rows each
    kept."""
    import topo_audio_autoencoder_torch as port
    from topo_audio_autoencoder_torch.models import encoder
    from topo_audio_autoencoder_torch.training.train_step import make_loss_and_grads

    _, cfg, traffic, _ = tiny_cell()
    prog = common.program_model(torch, port, cfg, SEED, "cpu")
    ref = common.reference_model(torch, cfg, SEED, "cpu")
    corpus = inputs.make_clips(traffic["corpus_clips"], cfg["model"]["num_samples"], SEED, "corpus", "cpu")
    idx = inputs.index_groups(traffic["corpus_clips"], 2, traffic["batch"], traffic["group"], SEED)
    batch = corpus[torch.as_tensor(idx[1])][:, :, None, :]
    with kept_rows(encoder) as prog_rows:
        total, _, grads = make_loss_and_grads(prog)(batch, 5.0, SEED, 1)
    with kept_rows(ref_encoder) as ref_rows:
        parts, ref_grads = ref_train.loss_and_grads(ref, batch, 5.0, SEED, 1)
    with plant_packed("face_sum_bwd_zero"):
        fault_total, _, fault_grads = make_loss_and_grads(prog)(batch, 5.0, SEED, 1)
    fault = (float(fault_total), fault_grads)
    return cfg, float(total), grads, prog_rows, parts["total_loss"], ref_grads, ref_rows, fault


def test_packed_loss_and_gradients_match_the_reference(step_pair):
    """At the tolerances of the flagship's ``test_train_step_loss_and_gradients``
    (``portbench/tests/test_portbench_reference.py``): the loss at 1e-6
    relative, the whole gradient at 1e-4 relative L2."""
    _, total, grads, _, loss, ref_grads, _, _ = step_pair
    assert abs(total - loss) <= 1e-6 * abs(loss)
    assert set(grads) == set(ref_grads)
    assert rel_l2(grads, ref_grads) <= 1e-4
    for name in ("encoder.embed_rank2", "encoder.embed_rank3"):
        assert float(ref_grads[name].norm()) > 0.0, name


@pytest.mark.parametrize("rank", [2, 3])
def test_packed_ranks_keep_the_same_rows(step_pair, rank):
    """Both truncate (capacity under the rank's size) and keep the same set
    of rows in every clip; the order among equal keys may differ."""
    cfg, _, _, prog_rows, _, _, ref_rows, _ = step_pair
    assert len(prog_rows) == len(ref_rows) == 1
    prog_idx, ref_idx = prog_rows[0][rank], ref_rows[0][rank]
    cap = cfg["model"]["pack_capacities"][rank]
    assert prog_idx.shape == ref_idx.shape and prog_idx.shape[-1] == cap < common.rank_sizes(10)[rank]
    assert torch.equal(prog_idx.sort(dim=-1).values, ref_idx.sort(dim=-1).values)
    assert all(prog_rows[0][r] is None and ref_rows[0][r] is None for r in (0, 1))


def test_face_sum_fault_moves_the_gradient(step_pair):
    """The planted ``face_sum_bwd_zero`` leaves the loss as it is and
    moves the whole gradient a hundred times the tolerance off the
    reference's."""
    _, _, _, _, loss, ref_grads, _, (fault_total, fault_grads) = step_pair
    assert abs(fault_total - loss) <= 1e-6 * abs(loss)
    assert rel_l2(fault_grads, ref_grads) > 1e-2


RUNS = {"sound_0": (None, 0), "sound_1": (None, 1), **{f: (f, 0) for f in PACKED_FAULTS}}


def run_tiny(fault, trace: int) -> dict:
    """One tiny run of the cell, as ``harness.run_cell`` makes it, with
    ``fault`` planted (None: sound), over a window of a few steps."""
    entry, cfg, traffic, spec = tiny_cell()
    with plant_packed(fault) if fault else contextlib.nullcontext():
        return harness.run_cell(torch, "cpu", tiny.BENCH, entry, cfg, traffic, spec,
                                tiny.args(trace=trace, seconds=0.5), time.perf_counter())


@pytest.fixture(scope="module")
def runs():
    """``RUNS``' results from one child process: a run loads no JAX (the
    harness refuses one that did), and this process has it loaded."""
    code = (
        "import json, sys; sys.path[:0] = ['.', 'tests']; import torch; torch.set_num_threads(2);"
        "import test_torch_packed_train as t;"
        "[print(json.dumps([k, t.run_tiny(*v)], default=str)) for k, v in t.RUNS.items()]"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(json.loads(line) for line in out.stdout.splitlines() if line.startswith("["))


@pytest.mark.parametrize("trace", [0, 1])
def test_sound_packed_cell_is_correct(runs, trace):
    result = runs[f"sound_{trace}"]
    assert result["correct"], result["checked"]
    assert list(result["checked"]) == list(tiny_cell()[3]["limits"])
    if trace:
        assert result["metrics"]["packed_ops_host_ms.train"]["value"] > 0.0
    else:
        assert {"train_anchors_per_s", "setup_s"} <= set(result["metrics"])


@pytest.mark.parametrize("fault", PACKED_FAULTS)
def test_packed_fault_is_not_correct(runs, fault):
    """The packed operators broken underneath the harness: the cell's check
    comes out false."""
    result = runs[fault]
    assert not result["correct"], result["checked"]


def test_face_sum_fault_fails_the_turned_share(runs):
    """The fault that every norm of the check misses turns more large
    leaves than the limit allows."""
    entry = runs["face_sum_bwd_zero"]["checked"]["grad_turned_share_large"]
    assert entry["value"] > entry["limit"]


def test_control_is_not_correct():
    """The reference in the cell's control precision (fp8), put in the
    program's place, fails the cell's limits."""
    _, cfg, traffic, spec = tiny_cell()
    cell = harness.make_cell(torch, cfg, traffic, spec, 2**31 + 23, "cpu")
    cell.setup()
    cell.release()
    numbers = train_directions.train_numbers(cell.reference_readings(control=True), cell.reference_readings())
    correct, rows = train_directions.check.judge(numbers, spec["limits"])
    assert not correct, rows


def test_kind_reference_readings_are_the_references():
    """The kind's reference steps give ``reference.train.readings``' numbers
    bit for bit, and the first clipped gradient whose norms they are."""
    _, cfg, traffic, _ = tiny_cell()
    corpus = inputs.make_clips(traffic["corpus_clips"], cfg["model"]["num_samples"], SEED, "corpus", "cpu")
    idx = inputs.index_groups(traffic["corpus_clips"], 2, traffic["batch"], traffic["group"], SEED)
    batches = [corpus[torch.as_tensor(i)][:, :, None, :] for i in idx[:2]]
    ours = train_directions.readings(common.reference_model(torch, cfg, SEED, "cpu"), batches, 5.0, SEED, 2, None)
    theirs = ref_train.readings(common.reference_model(torch, cfg, SEED, "cpu"), batches, 5.0, SEED, 2)
    assert set(ours) == set(theirs) | {"grads"}
    assert all(ours[k] == theirs[k] for k in theirs)
    assert ref_train.leaf_norms(ours["grads"]) == theirs["grad_norms"]


def _leaves(seed: int = 0) -> dict:
    gen = torch.Generator().manual_seed(seed)
    grads = {f"w{i}": torch.randn(32, 64, generator=gen) for i in range(4)}
    grads["bias"] = torch.randn(8, generator=gen)  # under LARGE_LEAF: left out
    return {"grads": grads, "grad_norms": ref_train.leaf_norms(grads),
            "numel": {n: g.numel() for n, g in grads.items()}}


def _turned(ref: dict, name: str, degrees: float) -> dict:
    """``ref`` with leaf ``name`` turned by ``degrees`` in the plane of its
    gradient and a unit vector orthogonal to it, the norm kept."""
    g = ref["grads"][name]
    other = torch.randn(g.shape, generator=torch.Generator().manual_seed(9))
    other = other - (other * g).sum() / (g * g).sum() * g
    other = other / other.norm() * g.norm()
    rad = torch.tensor(degrees * 3.141592653589793 / 180.0)
    return {**ref["grads"], name: torch.cos(rad) * g + torch.sin(rad) * other}


@pytest.mark.parametrize("degrees,share", [(0.0, 0.0), (30.0, 0.0), (44.0, 0.0), (46.0, 0.25), (90.0, 0.25),
                                           (180.0, 0.25)])
def test_turned_share_counts_leaves_past_45_degrees(degrees, share):
    ref = _leaves()
    value, detail = train_directions.turned_share({"grads": _turned(ref, "w1", degrees)}, ref)
    assert value == share
    assert detail == f"{int(share * 4)} of 4"


def test_turned_share_is_free_of_scale():
    """A common scale (the clip's) turns nothing; a leaf gone to zero or a
    turned small leaf is counted and left out as ``check.py`` does."""
    ref = _leaves()
    scaled = {n: 0.3 * g for n, g in ref["grads"].items()}
    assert train_directions.turned_share({"grads": scaled}, ref) == (0.0, "0 of 4")
    zero = {**ref["grads"], "w2": torch.zeros_like(ref["grads"]["w2"])}
    assert train_directions.turned_share({"grads": zero}, ref)[0] == 0.25
    flipped = {**ref["grads"], "bias": -ref["grads"]["bias"]}
    assert train_directions.turned_share({"grads": flipped}, ref)[0] == 0.0
