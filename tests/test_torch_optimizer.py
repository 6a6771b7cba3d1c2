"""The optimizer's multi-tensor update (``ops.multi_tensor_adam``) on the CPU:
the kernels' chunk table covers every element once, and the CPU path (the
plain version) gives the per-leaf optimizer's bits, as that optimizer was
written before the update went multi-tensor. The kernels themselves are held
against the plain version on the card (tests/test_torch_kernels.py)."""

import copy

import numpy as np
import pytest
import torch
from torch import nn

from topo_audio_autoencoder_torch.ops import multi_tensor_adam as mta
from topo_audio_autoencoder_torch.training import make_optimizer
from topo_audio_autoencoder_torch.training.train_step import bias_corrections

UPDATES = 3

# The kernels' threads a block and four-element slots a thread
# (csrc/multi_tensor_adam.cu): thread t takes slots t, t + 256, t + 512 and
# t + 768 of each chunk.
THREADS, SLOTS = 256, 4


def _leaf_of(first_chunk, count, c):
    """The kernels' leaf_of: the last leaf whose first chunk is <= c."""
    lo, hi = 0, count
    while hi - lo > 1:
        mid = (lo + hi) >> 1
        if first_chunk[mid] <= c:
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("sizes,max_leaves", [
    ([1], mta.MAX_LEAVES),
    ([3, 0, 5, 4096, 4097, 0, 0, 1, 8191, 12289], mta.MAX_LEAVES),
    ([0, 0, 7], 2),
    ([4095, 1, 4096, 2, 3, 9000, 0, 5], 3),
    (list(np.random.default_rng(0).integers(0, 20000, 1500)), mta.MAX_LEAVES),
], ids=["one", "ragged", "empty_first", "batches_of_3", "1500_leaves"])
def test_the_chunk_table_covers_every_element_once(sizes, max_leaves):
    """Every element of every leaf belongs to exactly one (chunk, thread,
    slot, lane) of the kernels' walk over ``plan``'s tables, each batch of
    at most ``max_leaves`` leaves in order."""
    slot_elements = np.array([4 * (t + k * THREADS) + i for t in range(THREADS) for k in range(SLOTS)
                              for i in range(4)])
    assert np.array_equal(np.sort(slot_elements), np.arange(mta.CHUNK))
    covered = [np.zeros(n, dtype=np.int64) for n in sizes]
    tables = mta.plan(sizes, max_leaves)
    assert [first for first, _, _ in tables] == list(range(0, len(sizes), max_leaves))
    for first, count, first_chunk in tables:
        assert first_chunk.dtype == np.int32 and len(first_chunk) == count + 1 and count <= max_leaves
        for c in range(int(first_chunk[-1])):
            leaf = _leaf_of(first_chunk, count, c)
            start = (c - int(first_chunk[leaf])) * mta.CHUNK
            length = min(mta.CHUNK, sizes[first + leaf] - start)
            assert length > 0
            elements = slot_elements[slot_elements < length]
            np.add.at(covered[first + leaf], start + elements, 1)
    assert all(bool((c == 1).all()) for c in covered)


def _model():
    """Leaves of both groups and of odd sizes, a norm's 1-d weight among
    them."""
    torch.manual_seed(3)
    return nn.ModuleDict({
        "encoder": nn.ModuleDict({"proj": nn.Linear(37, 11), "norm": nn.LayerNorm(11)}),
        "decoder": nn.ModuleDict({"conv": nn.Conv1d(3, 5, 7), "out": nn.Linear(13, 1)}),
    })


def _updates(template: dict, accumulate: int) -> list:
    """UPDATES x accumulate micro-steps of small normals; update 1's
    micro-steps 1e4 times larger, so that the clip engages."""
    rng = np.random.default_rng(accumulate)
    grads = [{n: torch.tensor(rng.standard_normal(tuple(t.shape)) * 1e-3, dtype=torch.float32)
              for n, t in template.items()} for _ in range(UPDATES * accumulate)]
    for i in range(accumulate):
        grads[accumulate + i] = {n: g * 1e4 for n, g in grads[accumulate + i].items()}
    return grads


def _per_leaf_update(opt, grads: dict, state: dict, params: dict) -> None:
    """One applied update of the per-leaf optimizer as it was written before
    the multi-tensor update: ``_clip``, then ``adam_update`` per leaf."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    keep = norm < opt.max_norm
    grads = {k: torch.where(keep, g, (g / norm) * opt.max_norm) for k, g in grads.items()}
    state["count"] += 1
    bc1, bc2 = bias_corrections(state["count"])
    for name, g in grads.items():
        mu = (1.0 - 0.9) * g + 0.9 * state["mu"][name]
        nu = (1.0 - 0.999) * (g * g) + 0.999 * state["nu"][name]
        state["mu"][name], state["nu"][name] = mu, nu
        params[name].add_(((mu / bc1) / (torch.sqrt(nu / bc2) + 1e-8)) * -opt.learning_rate(name))


@pytest.mark.parametrize("flat", [False, True], ids=["per_leaf", "flat"])
@pytest.mark.parametrize("accumulate", [1, 2])
def test_the_cpu_update_gives_the_per_leaf_optimizers_bits(flat, accumulate):
    """``Optimizer.update`` on CPU tensors (the plain version, in either
    layout) against the per-leaf optimizer as it was: parameters and
    moments bit for bit after UPDATES updates, one of them clipped."""
    models = [_model()]
    models.append(copy.deepcopy(models[0]))
    params = [dict(m.named_parameters()) for m in models]
    opt = make_optimizer(accumulate_grad_batches=accumulate, flat_groups=flat)
    state = opt.init(models[0])
    want = {"count": 0, "mu": {n: torch.zeros_like(p) for n, p in params[1].items()},
            "nu": {n: torch.zeros_like(p) for n, p in params[1].items()}}
    micro = _updates(params[0], accumulate)
    norms = []
    with torch.no_grad():
        for i in range(0, len(micro), accumulate):
            for g in micro[i:i + accumulate]:
                opt.update({n: t.clone() for n, t in g.items()}, state, models[0])
            mean = micro[i] if accumulate == 1 else {n: micro[i][n] + (micro[i + 1][n] - micro[i][n]) / 2
                                                     for n in micro[i]}
            norms.append(float(torch.sqrt(sum((t * t).sum() for t in mean.values()))))
            _per_leaf_update(opt, mean, want, params[1])
    assert max(norms) > opt.max_norm > min(norms) and state.count == want["count"] == UPDATES
    for n, p in params[0].items():
        assert torch.equal(p, params[1][n]), n
    groups = opt.groups(params[0])
    for what in ("mu", "nu"):
        got = getattr(state, what)
        for group, names in groups.items():
            leaves = torch.cat([want[what][n].reshape(-1) for n in names])
            assert torch.equal(got[group] if flat else torch.cat([got[n].reshape(-1) for n in names]), leaves), \
                (what, group)


def test_the_wrapper_refuses_other_devices_and_unpaired_lists():
    g = [torch.zeros(3, device="meta")]
    with pytest.raises(ValueError, match="cpu or cuda"):
        mta.multi_tensor_clip_adam(g, g, g, g, [-1e-3], 10.0, (0.1, 0.001))
    g = [torch.zeros(3)]
    with pytest.raises(ValueError, match="one gradient"):
        mta.multi_tensor_clip_adam(g, g, g, g, [], 10.0, (0.1, 0.001))
    with pytest.raises(ValueError, match="one gradient"):
        mta.multi_tensor_clip_adam([], [], [], [], [], 10.0, (0.1, 0.001))
    launches = mta.multi_tensor_clip_adam.launches
    mta.multi_tensor_clip_adam([torch.ones(3)], [torch.zeros(3)], [torch.zeros(3)], [torch.zeros(3)], [-1e-3],
                               10.0, bias_corrections(1))
    assert mta.multi_tensor_clip_adam.launches == launches
