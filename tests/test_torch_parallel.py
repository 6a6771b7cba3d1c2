"""The port's data parallelism on the CPU: gloo process groups of 2 and 4
ranks against the port's 1-process step, trainer and tuner, and against
the JAX package's data-parallel step on the conftest's 8-device mesh.

Each group is spawned (forking a process that holds JAX's threads can
deadlock), meets through a file in the test's ``tmp_path`` (fixed ports
collide across the suite's workers), bounds every collective by
``TIMEOUT_S`` and every join by ``JOIN_S``, so that a hung rank fails its
test. The rank workers live in this module, which imports no JAX at import
time; each reports whether JAX was imported in its process.

The invariant, as the JAX package's ``tests/test_parallel.py`` holds it:
the D-rank step is the 1-rank step on the same batch and seed. Each rank
draws every random number at the global batch's shape and keeps its rows,
so the ranks see the noise one process sees.
"""

from __future__ import annotations

import os
import sys
import time
import traceback
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from _torch_parity import TINY, flax_params, waveforms

from topo_audio_autoencoder_torch.data import (
    ContrastiveConfig,
    NSynthDataset,
    compute_distances,
    index_iterator,
    synth_corpus,
)
from topo_audio_autoencoder_torch.models import AudioAutoencoder
from topo_audio_autoencoder_torch.ops.fused_hard_concrete import hard_concrete_learned_sample, hard_concrete_sample
from topo_audio_autoencoder_torch.ops.fused_samplers import binary_gumbel_sample, philox_uniform
from topo_audio_autoencoder_torch.ops.samplers import RowShard, binary_gumbel, hard_concrete, uniform_noise
from topo_audio_autoencoder_torch.models.encoder import dropout as port_dropout
from topo_audio_autoencoder_torch.parallel import make_mesh, shard_batch
from topo_audio_autoencoder_torch.training import (
    Trainer,
    TrainerConfig,
    VmappedGridTuner,
    create_train_state,
    make_loss_and_grads,
    make_optimizer,
    make_train_step,
)

torch.set_num_threads(1)

T = 2048
B, G = 8, 3  # the global batch: 8 rows divide the JAX test's 8 devices
SEED = 3
TEMPERATURE = 1.0
TIMEOUT_S = 60
JOIN_S = 300
SMALL = dict(num_vertices=4, num_bands=4, sccn_hidden_dim=8, n_sccn_layers=1)
TRAIN_CLIPS, VAL_CLIPS = 17, 6  # odd: the sharded corpus pads; validate pads its batch
GRID = {"encoder_lr": [1e-3, 5e-4], "decoder_lr": [1e-4], "complexity_penalty": [0.1]}
GATHER_ROWS = 19  # not a multiple of 2 or 4
# The step off the default path (soft Gumbel): BASELINE config 3's hard
# Hard Concrete (per-rank Bernoulli rows), the learned stretch, and a
# packed model (ranks 2-3 at half their rows); each from its own seed.
OFF_DEFAULT = {
    "hard_concrete_hard": dict(TINY, sampler="hard_concrete", hard=True),
    "learned_hc": dict(TINY, sampler="hard_concrete", learned_hc=True),
    "packed": dict(num_vertices=8, num_bands=4, sccn_hidden_dim=8, n_sccn_layers=2, max_active_vertices=8,
                   pack_capacities=(0, 0, 28, 35)),
}


# ------------------------------------------------------------------ workers


def _pg_rank(rank: int, world: int, tmp: str, job: str) -> None:
    """One rank of a gloo group: joins through ``tmp``, runs ``job`` and
    saves what it returns (or the traceback) to ``<job>_<rank>.pt``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    torch.set_num_threads(1)
    out = {}
    try:
        mesh = make_mesh(world, device="cpu", init_method=f"file://{tmp}/pg_{job}", timeout=TIMEOUT_S)
        try:
            out = JOBS[job](mesh, Path(tmp))
        finally:
            mesh.close()
    except BaseException:
        out = {"error": traceback.format_exc()}
    out["jax_imported"] = any(m == "jax" or m.startswith("jax.") for m in sys.modules)
    torch.save(out, Path(tmp) / f"{job}_{rank}.pt")


def _tiny(state_dict, dropout: float) -> AudioAutoencoder:
    model = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu", dropout=dropout)
    model.load_state_dict(state_dict)
    return model


def _step_results(mesh, inputs: dict) -> dict:
    """The step with dropout on (its own draws), its update, and the step
    with dropout off on JAX's uniforms; with ``mesh`` on this rank's rows."""
    batch = shard_batch(inputs["batch"], mesh)
    model = _tiny(inputs["state_dict"], 0.1)
    total, comps, grads = make_loss_and_grads(model, mesh=mesh)(batch, TEMPERATURE, SEED, 0)
    opt = make_optimizer(accumulate_grad_batches=1)
    step = make_train_step(model, opt, mesh=mesh)
    state, metrics = step(create_train_state(model, opt), batch, TEMPERATURE, SEED)
    quiet = _tiny(inputs["state_dict"], 0.0)
    jax_noise = shard_batch(inputs["jax_noise"], mesh)
    jtotal, _, jgrads = make_loss_and_grads(quiet, mesh=mesh)(batch, TEMPERATURE, 0, 0, jax_noise)
    return dict(total=total, comps=comps, grads=grads, metrics=metrics,
                params={n: p.detach().clone() for n, p in model.named_parameters()},
                jax_total=jtotal, jax_grads=jgrads)


def _off_default_model(case: str) -> AudioAutoencoder:
    return AudioAutoencoder.create(**OFF_DEFAULT[case], num_samples=T, device="cpu", seed=11, dropout=0.1)


def _off_default_steps(mesh, inputs: dict) -> dict:
    """Each OFF_DEFAULT model's step (loss and gradients, dropout on) on
    this rank's rows."""
    batch = shard_batch(inputs["batch"], mesh)
    out = {}
    for case in OFF_DEFAULT:
        total, _, grads = make_loss_and_grads(_off_default_model(case), mesh=mesh)(batch, TEMPERATURE, SEED, 0)
        out[case] = dict(total=total, grads=grads)
    return out


def _split_step(model, batch) -> tuple:
    """The mean loss and the mean gradient of the 1-process step on the
    batch's two halves, each computed alone with its rows of the whole
    batch's draws: what two ranks compute, with no collective."""
    import topo_audio_autoencoder_torch.training.train_step as train_step_mod

    b = batch.shape[0]
    halves = []
    for r in range(2):
        with mock.patch.object(train_step_mod, "row_shard", lambda mesh, r=r: RowShard(r, 2)):
            half = make_loss_and_grads(model)
        halves.append(half(batch[r * b // 2 : (r + 1) * b // 2], TEMPERATURE, SEED, 0))
    total = (halves[0][0] + halves[1][0]) / 2
    return total, {n: (halves[0][2][n] + halves[1][2][n]) / 2 for n in halves[0][2]}


def _trainer_data():
    corpus = synth_corpus(TRAIN_CLIPS, n_samples=T, seed=1)
    dists = compute_distances(corpus, tile=TRAIN_CLIPS, scales=(256,), device="cpu")
    cfg = ContrastiveConfig(num_negative_samples=1)
    return (NSynthDataset(corpus, dists["neighbors"], train=True, config=cfg),
            NSynthDataset(synth_corpus(VAL_CLIPS, n_samples=T, seed=2), train=False))


def _trainer_run(mesh, directory: Path, **kw) -> dict:
    """One epoch of the Trainer (two scanned steps of B = 8, a validate
    over a padded batch, checkpoints, the log and a dump), counting the
    writes this process made."""
    import topo_audio_autoencoder_torch.training.trainer as trainer_mod
    from topo_audio_autoencoder_torch.training import CheckpointManager, MetricWriter, TrainingMetrics

    writes = []

    def counted(fn, what):
        def run(*a, **k):
            writes.append(what)
            return fn(*a, **k)
        return run

    train, val = _trainer_data()
    model = AudioAutoencoder.create(**SMALL, num_samples=T, device="cpu")
    config = TrainerConfig(checkpoint_dir=str(directory), batch_size=B, accumulate_grad_batches=1, max_epochs=1,
                           log_every=1, with_grad_norms=False, scan_steps=2, device="cpu",
                           data_parallel=mesh is not None, **kw)
    with mock.patch.object(CheckpointManager, "save", counted(CheckpointManager.save, "checkpoint")), \
            mock.patch.object(MetricWriter, "write", counted(MetricWriter.write, "log")), \
            mock.patch.object(TrainingMetrics, "save", counted(TrainingMetrics.save, "metrics")), \
            mock.patch.object(trainer_mod, "save_wav", counted(trainer_mod.save_wav, "wav")):
        trainer = Trainer(model, train, val, config=config)
        m = trainer.train()
    return dict(train=m.train_losses, val=m.val_losses, iteration=m.iteration_losses, writes=sorted(set(writes)),
                params={n: p.detach().clone() for n, p in model.named_parameters()})


def _tune(mesh) -> dict:
    train, val = _trainer_data()
    model = AudioAutoencoder.create(**SMALL, num_samples=T, device="cpu")
    tuner = VmappedGridTuner(model, mesh=mesh)
    result = tuner.tune(
        GRID,
        train_batches=lambda e: index_iterator(train, B, seed=SEED, epoch=e),
        val_batches=lambda: index_iterator(val, 2, shuffle=False),
        epochs=1, seed=SEED, corpus=train.waveforms, val_corpus=val.waveforms, scan_steps=2,
    )
    return dict(val=result["val_losses"], curve=result["train_curve"], best=result["best_index"],
                params={n: p.clone() for n, p in result["state"].params.items()})


def _job_pair(mesh, tmp: Path) -> dict:
    """The 2-rank group: the steps, the sharded gather, the Trainer with
    and without ``shard_corpus``, the tuner."""
    inputs = torch.load(tmp / "inputs.pt", weights_only=False)
    out = dict(step=_step_results(mesh, inputs), off_default=_off_default_steps(mesh, inputs))
    out["gather"] = _gather(mesh, inputs)
    out["trainer"] = {shard: _trainer_run(mesh, tmp / f"dp_{shard}", shard_corpus=shard) for shard in (False, True)}
    out["tune"] = _tune(mesh)
    return out


def _gather(mesh, inputs: dict) -> dict:
    from topo_audio_autoencoder_torch.training import make_sharded_corpus_gather

    corpus_dev, gather = make_sharded_corpus_gather(mesh, inputs["corpus"])
    return dict(rows=tuple(corpus_dev.shape), local=corpus_dev.clone(), batch=gather(corpus_dev, inputs["idx"]))


def _job_quad(mesh, tmp: Path) -> dict:
    return dict(gather=_gather(mesh, torch.load(tmp / "inputs.pt", weights_only=False)))


JOBS = {"pair": _job_pair, "quad": _job_quad}


def _spawn(tmp: Path, job: str, world: int) -> list:
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_pg_rank, args=(r, world, str(tmp), job), daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    return procs


def _join(tmp: Path, job: str, procs: list) -> list:
    deadline = time.monotonic() + JOIN_S
    for p in procs:
        p.join(max(0.0, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    assert not hung, f"{job}: ranks {hung} still running after {JOIN_S} s"
    outs = [torch.load(tmp / f"{job}_{r}.pt", weights_only=False) for r in range(len(procs))]
    for r, o in enumerate(outs):
        assert "error" not in o, f"{job} rank {r}:\n{o['error']}"
        assert not o["jax_imported"], f"{job} rank {r} imported JAX"
    return outs


# ------------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def groups(tmp_path_factory):
    """Starts both groups on shared inputs, computes the 1-process and JAX
    references while they run, then joins them."""
    import jax

    from topo_audio_autoencoder_torch.convert import state_dict_from_flax
    from topo_audio_autoencoder_tpu.models import AudioAutoencoder as JaxAutoencoder

    tmp = tmp_path_factory.mktemp("dp")
    jm = JaxAutoencoder.create(**TINY, dropout=0.0)
    params = flax_params(jm, num_samples=T)
    template = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu").state_dict()
    rng = np.random.default_rng(5)
    inputs = dict(
        state_dict=state_dict_from_flax(params, template),
        batch=torch.from_numpy(waveforms(7, B * G, T).reshape(B, G, 1, T)),
        jax_noise=torch.from_numpy(np.array(_jax_noise(jax, jm.tables.total_simplices))),
        corpus=rng.standard_normal((GATHER_ROWS, 64)).astype(np.float32),
        idx=rng.integers(0, GATHER_ROWS, size=(16, 3)).astype(np.int64),
    )
    torch.save(inputs, tmp / "inputs.pt")
    running = {"pair": _spawn(tmp, "pair", 2), "quad": _spawn(tmp, "quad", 4)}
    ref = dict(inputs=inputs, jm=jm, params=params, step=_step_results(None, inputs),
               off_default={case: _split_step(_off_default_model(case), inputs["batch"]) for case in OFF_DEFAULT},
               floors=_one_process_floors(inputs), trainer=_trainer_run(None, tmp / "single"), tune=_tune(None))
    ref["jax"] = _jax_dp_step(jax, jm, params, inputs)
    return dict(ref=ref, tmp=tmp, **{job: _join(tmp, job, procs) for job, procs in running.items()})


def _l2(tensors) -> float:
    return float(np.sqrt(sum(float((t.double() ** 2).sum()) for t in tensors)))


def _rel_l2(got: dict, want: dict) -> float:
    return _l2(got[n] - want[n] for n in want) / _l2(want.values())


def _one_process_floors(inputs: dict) -> dict:
    """What the 1-process step's gradient does when only the order of its
    sums changes.

    ``split``: the mean of the gradients of the batch's two halves, each
    computed alone with its rows of the whole batch's draws (what two ranks
    compute, with no collective). ``floor``: the largest change of the
    whole gradient (relative L2) when the batch's rows are reordered
    (reversed, halves swapped, rolled by one), every row keeping its
    sampler and dropout uniforms."""
    import topo_audio_autoencoder_torch.models.encoder as encoder_mod
    import topo_audio_autoencoder_torch.training.train_step as train_step_mod
    from topo_audio_autoencoder_torch.ops.fused_samplers import seed_from

    model = _tiny(inputs["state_dict"], 0.1)
    batch = inputs["batch"]
    b = batch.shape[0]
    loss_and_grads = make_loss_and_grads(model)
    _, _, whole = loss_and_grads(batch, TEMPERATURE, SEED, 0)
    _, split = _split_step(model, batch)
    seed = seed_from(train_step_mod.step_generators(SEED, 0, "cpu")[0])
    noise = philox_uniform(b * model.encoder.total_simplices, seed).reshape(b, -1)
    rand_rows = encoder_mod.rand_rows
    floor = 0.0
    for order in (torch.arange(b).flip(0), torch.arange(b).roll(b // 2), torch.arange(b).roll(1)):
        def reordered(shape, generator, shard=None, order=order):  # the dropout rows follow their clips
            u = rand_rows(shape, generator, shard)
            return u.reshape(b, -1, *u.shape[1:])[order].reshape(u.shape)

        with mock.patch.object(encoder_mod, "rand_rows", reordered):
            _, _, got = loss_and_grads(batch[order], TEMPERATURE, SEED, 0, noise[order])
        floor = max(floor, _rel_l2(got, whole))
    return dict(split=split, floor=floor)


def _jax_noise(jax, total_simplices: int):
    """The uniforms the JAX train step draws for the anchors' sampler at
    step 0 (tests/test_torch_training.py's ``jax_step_noise``)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED), 0)
    srng, _ = jax.random.split(rng)
    sample_rng, _ = jax.random.split(srng)
    return jax.random.uniform(sample_rng, (B, total_simplices), minval=1e-6, maxval=1.0 - 1e-6)


def _jax_dp_step(jax, jm, params, inputs) -> dict:
    """The JAX step over the 8-device mesh (tests/test_parallel.py's set-up),
    with an optimizer that records the gradient it is given."""
    import jax.numpy as jnp
    import optax

    from topo_audio_autoencoder_tpu.parallel import make_mesh as jax_make_mesh
    from topo_audio_autoencoder_tpu.parallel import replicate, shard_batch as jax_shard_batch
    from topo_audio_autoencoder_tpu.training import TrainState, make_train_step as jax_make_train_step

    record = optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), {"g": u}),
    )
    mesh = jax_make_mesh()
    p = jax.tree.map(jnp.asarray, params)
    state = replicate(TrainState(params=p, opt_state=record.init(p), step=jnp.int32(0)), mesh)
    step = jax_make_train_step(jm, record, donate=False)
    with mesh:
        new, metrics = step(state, jax_shard_batch(jnp.asarray(inputs["batch"].numpy()), mesh), TEMPERATURE,
                            jax.random.PRNGKey(SEED))
    return dict(total=float(metrics["total_loss"]), grads=jax.tree.map(np.asarray, new.opt_state["g"]))


# ------------------------------------------------------------------ (a) draws


@pytest.mark.parametrize("first", [1, 3, 6, 6195, 8 * 6195, 2**34 + 5])
def test_philox_from_first_equals_the_global_stream(first):
    n = 4097
    whole = philox_uniform(first + n, seed=77, offset=9) if first < 10**6 else None
    got = philox_uniform(n, seed=77, offset=9, first=first)
    if whole is not None:
        assert torch.equal(got, whole[first:])
    # against the stream's own group layout: element e is word e & 3 of group e >> 2
    lead = first & 3
    groups = philox_uniform(lead + n, seed=77, offset=9, first=first - lead)
    assert torch.equal(got, groups[lead:])
    assert torch.equal(philox_uniform(n, seed=77, offset=9, first=0), philox_uniform(n, seed=77, offset=9))


# torch's CPU sigmoid rounds a vector's tail apart from its body, so the
# same element can differ by an ulp between two lengths; the uniforms may not.
ULP2 = 2.0 ** -22


@pytest.mark.parametrize("rank,world", [(0, 2), (1, 2), (3, 4)])
def test_fused_samplers_draw_the_rows_of_the_global_sample(rank, world):
    """Rows 3-5's plain versions with ``first`` = the rank's first element:
    the rank's rows of the whole batch's uniforms bit for bit, and of its
    sample to the CPU's rounding."""
    s = 37  # an odd row length: odd starts
    gen = torch.Generator().manual_seed(1)
    logits = torch.randn(4 * world, s, generator=gen)
    beta = torch.rand(s, generator=gen) + 0.3
    gamma = -torch.rand(s, generator=gen) * 0.2
    zeta = 1 + torch.rand(s, generator=gen) * 0.2
    shard = RowShard(rank, world)
    mine = shard_batch(logits, _FakeMesh(rank, world))
    first = shard.first(mine.numel())
    kw = dict(seed=5, return_noise=True)
    pairs = [
        (binary_gumbel_sample(logits, 0.7, **kw), binary_gumbel_sample(mine, 0.7, first=first, **kw)),
        (hard_concrete_sample(logits, 0.7, **kw), hard_concrete_sample(mine, 0.7, first=first, **kw)),
        (hard_concrete_learned_sample(logits, beta, gamma, zeta, **kw),
         hard_concrete_learned_sample(mine, beta, gamma, zeta, first=first, **kw)),
    ]
    rows = _FakeMesh(rank, world)
    for (whole, u_whole), (got, u) in pairs:
        assert torch.equal(u, shard_batch(u_whole, rows))
        torch.testing.assert_close(got, shard_batch(whole, rows), rtol=ULP2, atol=0.0)


def test_plain_samplers_and_dropout_draw_the_rows_of_the_global_draw():
    shard = RowShard(1, 2)
    logits = torch.randn(6, 11, generator=torch.Generator().manual_seed(2))
    mine = logits[3:]

    def gen():
        return torch.Generator().manual_seed(9)

    assert torch.equal(uniform_noise((3, 11), gen(), "cpu", shard), uniform_noise((6, 11), gen(), "cpu")[3:])
    assert torch.equal(port_dropout(mine, 0.3, gen(), shard=shard), port_dropout(logits, 0.3, gen())[3:])
    for sample in (binary_gumbel, hard_concrete):
        torch.testing.assert_close(sample(mine, gen(), 0.5, shard=shard), sample(logits, gen(), 0.5)[3:],
                                   rtol=ULP2, atol=0.0)
    # one process is the block 0 of 1: the draw as it was
    assert torch.equal(binary_gumbel(logits, gen(), 0.5, shard=RowShard()), binary_gumbel(logits, gen(), 0.5))


class _FakeMesh:
    """The rank and size ``shard_batch`` reads."""

    def __init__(self, rank, size):
        self.rank, self.size = rank, size


# ------------------------------------------------------------------ mesh


def test_make_mesh_needs_one_process_a_device(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        make_mesh(2, device="cpu")


def test_world_of_one_changes_no_bit():
    """A process launched alone is a world of one on a local store; its
    all-reduces change no bit of the step."""
    model = AudioAutoencoder.create(**SMALL, num_samples=T, device="cpu", seed=4)
    batch = torch.from_numpy(waveforms(8, 2 * G, T).reshape(2, G, 1, T))
    want = make_loss_and_grads(model)(batch, TEMPERATURE, SEED, 0)
    mesh = make_mesh(1, device="cpu", timeout=TIMEOUT_S)
    try:
        assert (mesh.rank, mesh.size, mesh.backend) == (0, 1, "gloo")
        got = make_loss_and_grads(model, mesh=mesh)(batch, TEMPERATURE, SEED, 0)
    finally:
        mesh.close()
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(got[1][k], want[1][k]) for k in want[1])
    assert all(torch.equal(got[2][n], want[2][n]) for n in want[2])


# ------------------------------------------------------------------ (b) 2 ranks vs 1 process

LOSS_RTOL = 1e-5
PARAM_ATOL = 2.5e-3  # Adam's first update, as tests/test_parallel.py holds it
# The two ranks' gradient against the 1-process step's on the whole batch,
# as a whole (relative L2), at twice the step's own floor: the largest
# change when the batch's rows are reordered (``_one_process_floors``;
# measured 4.3e-4 to 8.2e-4, the two ranks 1.25e-3). Leaf by leaf the
# ranks differ by up to 1.1e-3 of the gradient's largest element, 2.2 times
# the reorderings' 5.1e-4, so a bound of 1e-5 of it, every leaf, does not
# hold; leaf by leaf the ranks equal the 1-process step on the same two
# halves, bit for bit. The spectral loss's log term weighs near-empty STFT
# bins by ~1e7, so the order of the sums over the batch shows
# (tests/test_torch_training.py).
FLOOR_FACTOR = 2.0


def test_two_ranks_equal_one_process_loss_with_dropout(groups):
    want = groups["ref"]["step"]
    for out in groups["pair"]:
        got = out["step"]
        np.testing.assert_allclose(float(got["total"]), float(want["total"]), rtol=LOSS_RTOL)
        for k, v in want["comps"].items():
            np.testing.assert_allclose(float(got["comps"][k]), float(v), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
            np.testing.assert_allclose(float(got["metrics"][k]), float(v), rtol=LOSS_RTOL, atol=1e-7, err_msg=k)


def test_two_ranks_equal_the_split_step_bit_for_bit(groups):
    """Every leaf of the ranks' averaged gradient equals, bit for bit, the
    mean of the 1-process step's gradients on the two halves, each with its
    rows of the whole batch's draws: the collectives and the rank-row
    draws add nothing."""
    split = groups["ref"]["floors"]["split"]
    for out in groups["pair"]:
        got = out["step"]["grads"]
        assert got.keys() == split.keys()
        assert all(torch.equal(got[n], split[n]) for n in split)


@pytest.mark.parametrize("case", sorted(OFF_DEFAULT))
def test_two_ranks_equal_the_split_step_off_the_default_path_bit_for_bit(groups, case):
    """Off the soft Gumbel path (BASELINE config 3's hard Hard Concrete
    with its per-rank Bernoulli rows, the learned stretch, the packed
    model with its top-K select and packed gathers): the ranks' loss and
    every leaf of their gradient equal the split 1-process step's bit for
    bit, as on the default path."""
    want_total, want = groups["ref"]["off_default"][case]
    for out in groups["pair"]:
        got = out["off_default"][case]
        assert torch.equal(got["total"], want_total)
        assert got["grads"].keys() == want.keys()
        differ = [n for n in want if not torch.equal(got["grads"][n], want[n])]
        assert not differ, differ
    assert any(bool(g.abs().sum() > 0) for g in want.values())


def test_two_ranks_equal_one_process_gradient(groups):
    want = groups["ref"]["step"]["grads"]
    floor = groups["ref"]["floors"]["floor"]
    assert 0.0 < floor < 1e-2, floor  # the reorderings change round-off only
    got = groups["pair"][0]["step"]["grads"]
    err = _rel_l2(got, want)
    assert err <= FLOOR_FACTOR * floor, (err, floor)


def test_two_ranks_equal_one_process_after_the_update(groups):
    want = groups["ref"]["step"]["params"]
    a, b = (out["step"]["params"] for out in groups["pair"])
    for n, w in want.items():
        assert torch.equal(a[n], b[n]), n
        np.testing.assert_allclose(a[n].numpy(), w.numpy(), rtol=0.0, atol=PARAM_ATOL, err_msg=n)


# ------------------------------------------------------------------ (c) 2 ranks vs the JAX DP step

JAX_LOSS_RTOL = 2e-5  # tests/test_torch_training.py's bounds for the single-device step
JAX_GRAD_REL_L2 = 1e-2


def test_two_ranks_equal_the_jax_data_parallel_step(groups):
    from topo_audio_autoencoder_torch.convert import state_dict_from_flax

    ref = groups["ref"]
    want_grads = state_dict_from_flax(ref["jax"]["grads"], ref["inputs"]["state_dict"])
    for out in groups["pair"]:
        got = out["step"]
        np.testing.assert_allclose(float(got["jax_total"]), ref["jax"]["total"], rtol=JAX_LOSS_RTOL)
        err = _l2(got["jax_grads"][n] - want_grads[n] for n in want_grads) / _l2(want_grads.values())
        assert err <= JAX_GRAD_REL_L2, err


# ------------------------------------------------------------------ (d) the sharded gather


@pytest.mark.parametrize("job,world", [("pair", 2), ("quad", 4)])
def test_sharded_corpus_gather_equals_the_index(groups, job, world):
    import jax.numpy as jnp

    from topo_audio_autoencoder_tpu.parallel import make_mesh as jax_make_mesh
    from topo_audio_autoencoder_tpu.training import make_sharded_corpus_gather as jax_gather

    inputs = groups["ref"]["inputs"]
    corpus, idx = inputs["corpus"], inputs["idx"]
    want = torch.from_numpy(corpus[idx][:, :, None, :])
    jdev, jg = jax_gather(jax_make_mesh(), corpus)
    jax_batch = torch.from_numpy(np.array(jg(jdev, jnp.asarray(idx.astype(np.int32)))))
    assert torch.equal(jax_batch, want)
    outs = groups[job]
    n_local = -(-GATHER_ROWS // world)
    for r, out in enumerate(outs):
        g = out["gather"]
        assert g["rows"] == (n_local, corpus.shape[1])
        held = corpus[r * n_local : (r + 1) * n_local]
        assert torch.equal(g["local"][: len(held)], torch.from_numpy(held))
        assert not g["local"][len(held):].any()
    got = torch.cat([out["gather"]["batch"] for out in outs])
    assert torch.equal(got, want)


# ------------------------------------------------------------------ (e) the Trainer


def test_trainer_shard_corpus_matches_replicated(groups):
    for out in groups["pair"]:
        rep, shard = out["trainer"][False], out["trainer"][True]
        np.testing.assert_allclose(shard["train"] + shard["val"], rep["train"] + rep["val"], rtol=1e-5)
    a, b = (out["trainer"][True]["params"] for out in groups["pair"])
    assert all(torch.equal(a[n], b[n]) for n in a)


def test_trainer_matches_one_process(groups):
    """The first step's loss, before any update, as the step's; after the
    epoch's two Adam updates the parameters as tests/test_parallel.py holds
    one update, per update. The losses after an update are not compared:
    Adam's first update moves each parameter by about lr * sign(g), and
    where g lies at the floor above its sign is the round-off's (a 1e-5
    nudge of the first gradient, relative to its largest element, moved
    the 1-process run's val loss by 13%, measured)."""
    want = groups["ref"]["trainer"]
    assert len(want["iteration"]) == 2 and np.isfinite(want["iteration"] + want["val"]).all()
    for out in groups["pair"]:
        for run in out["trainer"].values():
            assert len(run["iteration"]) == 2 and np.isfinite(run["iteration"] + run["val"]).all()
            np.testing.assert_allclose(run["iteration"][0], want["iteration"][0], rtol=LOSS_RTOL)
            for n, w in want["params"].items():
                np.testing.assert_allclose(run["params"][n].numpy(), w.numpy(), rtol=0.0, atol=2 * PARAM_ATOL,
                                           err_msg=n)


def test_only_rank_zero_writes(groups):
    want = groups["ref"]["trainer"]["writes"]
    assert want == ["checkpoint", "log", "metrics", "wav"]
    zero, one = groups["pair"]
    assert all(run["writes"] == want for run in zero["trainer"].values())
    assert all(run["writes"] == [] for run in one["trainer"].values())
    for shard in (False, True):
        ckpt = groups["tmp"] / f"dp_{shard}"
        assert (ckpt / "latest" / "state.pt").exists() and (ckpt / "train_log.jsonl").exists()


# ------------------------------------------------------------------ (f) the tuner


def test_tuner_on_two_ranks_matches_one_process(groups):
    """Every combo's first grid-step loss as the step's, every combo's
    parameters after two grid steps as the Trainer's (see there); both ranks
    hold the same grid and the same val losses."""
    want = groups["ref"]["tune"]
    a, b = (out["tune"] for out in groups["pair"])
    assert a["val"] == b["val"] and a["curve"] == b["curve"]
    assert all(torch.equal(a["params"][n], b["params"][n]) for n in a["params"])
    assert len(a["curve"]) == len(want["curve"]) == 2 and np.isfinite(a["val"]).all()
    np.testing.assert_allclose(a["curve"][0], want["curve"][0], rtol=LOSS_RTOL)
    for n, w in want["params"].items():
        np.testing.assert_allclose(a["params"][n].numpy(), w.numpy(), rtol=0.0, atol=2 * PARAM_ATOL, err_msg=n)
