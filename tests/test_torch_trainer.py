"""The port's Trainer against the JAX package's, and the port's own
guarantees, at the tiny config on the CPU.

Control flow: both trainers run the same grid tuning (a first pass, then a
second that resumes every combo from its latest checkpoint) and the same
main loop to early stopping, with the train and eval steps replaced by
recorders and ``validate`` by a scripted sequence of val losses, so no
model runs. Every step call, curriculum epoch, checkpoint save, validate
call, metric and file key must be the same in both. ``validate`` itself is
held against the JAX package's on the same parameters, through the array
path and the indexed path, at ``LOSS_RTOL``.
"""

import gc
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import TINY, flax_params, waveforms

import topo_audio_autoencoder_torch.training.checkpoint as pt_checkpoint
import topo_audio_autoencoder_torch.training.trainer as pt_trainer
import topo_audio_autoencoder_tpu.training.checkpoint as jax_checkpoint
import topo_audio_autoencoder_tpu.training.trainer as jax_trainer
from topo_audio_autoencoder_torch.convert import state_dict_from_flax
from topo_audio_autoencoder_torch.data import ContrastiveConfig, NSynthDataset, compute_distances, synth_corpus
from topo_audio_autoencoder_torch.inference import load_params, save_params
from topo_audio_autoencoder_torch.models import AudioAutoencoder
from topo_audio_autoencoder_torch.training import (
    CheckpointManager,
    Trainer,
    TrainerConfig,
    make_indexed_train_step,
    make_optimizer,
    make_scan_indexed_train_step,
    make_train_step,
)
from topo_audio_autoencoder_tpu.data import NSynthDataset as JaxDataset
from topo_audio_autoencoder_tpu.models import AudioAutoencoder as JaxAutoencoder
from topo_audio_autoencoder_tpu.training import MetricWriter as JaxMetricWriter
from topo_audio_autoencoder_tpu.training import Trainer as JaxTrainer
from topo_audio_autoencoder_tpu.training import TrainerConfig as JaxTrainerConfig
from topo_audio_autoencoder_tpu.training import TrainState as JaxTrainState
from topo_audio_autoencoder_tpu.training import component_grad_norms as jax_grad_norms
from topo_audio_autoencoder_tpu.training.losses import autoencoder_loss as jax_autoencoder_loss

torch.set_num_threads(1)

T = 2048  # the port refuses a reflect pad of 1024 (the 2048 STFT scale) on 1024 samples
SCALES = (256, 128)
# tests/test_trainer.py's model: the smallest that trains.
SMALL = dict(num_vertices=4, num_bands=4, sccn_hidden_dim=8, n_sccn_layers=1)
LOSS_RTOL = 2e-5  # as tests/test_torch_training.py holds the eval step
GRID = {"encoder_lr": [1e-3, 5e-4], "decoder_lr": [1e-4], "complexity_penalty": [0.1]}


@pytest.fixture(scope="module")
def corpus():
    train = synth_corpus(8, n_samples=T, seed=1)
    dists = compute_distances(train, tile=8, scales=SCALES, device="cpu")
    val = synth_corpus(4, n_samples=T, seed=2)
    return train, dists["neighbors"], val


@pytest.fixture(scope="module")
def model():
    return AudioAutoencoder.create(**SMALL, num_samples=T, device="cpu")


def _config(tmp_path, cls=TrainerConfig, **kw):
    defaults = dict(
        checkpoint_dir=str(tmp_path),
        batch_size=2,
        accumulate_grad_batches=1,
        max_epochs=2,
        patience=5,
        tuning_epochs=1,
        log_every=2,
        checkpoint_every_iters=0,
        checkpoint_every_epochs=1,
        dump_audio=False,
        with_grad_norms=False,
    )
    if cls is TrainerConfig:
        defaults["device"] = "cpu"
    defaults.update(kw)
    return cls(**defaults)


# G = 3 for the port's own runs: the contrastive term runs, at a quarter of
# the default G = 12's cost.
G3 = ContrastiveConfig(num_negative_samples=1)


def _datasets(corpus, cls=NSynthDataset, config=None):
    """Train and val datasets; ``config=None`` keeps the class's default
    (each package's own ``ContrastiveConfig()``, G = 12)."""
    train, neighbors, val = corpus
    kw = {} if config is None else {"config": config}
    return cls(train, neighbors, train=True, **kw), cls(val, train=False)


# ---------------------------------------------------------------- control flow


def _instrument(monkeypatch, mod, ckpt_mod, root, params_of, loss_of):
    """Replace the steps with recorders and spy on checkpoint saves; returns
    the event log the run fills."""
    events = {"steps": [], "saves": [], "validate": [], "set_epoch": []}
    holder = {}

    def fake_step_factory(*args, **kwargs):
        def step(state, idxs, temperature, seed):
            trainer = holder["trainer"]
            events["steps"].append((np.asarray(idxs).tolist(), float(temperature), int(state.step),
                                    dict(trainer.hyper)))
            return params_of(state), {"total_loss": loss_of(len(events["steps"]))}

        return step

    monkeypatch.setattr(mod, "make_indexed_train_step", fake_step_factory)
    monkeypatch.setattr(mod, "make_eval_step", lambda *a, **k: None)
    save = ckpt_mod.CheckpointManager.save

    def spy(self, name, state, extra=None):
        events["saves"].append((str(self.directory.relative_to(root.resolve())), name))
        return save(self, name, state, extra)

    monkeypatch.setattr(ckpt_mod.CheckpointManager, "save", spy)
    return events, holder


def _script(trainer, events, values):
    it = iter(values)

    def validate(dataset=None):
        events["validate"].append("val" if dataset is None else "test")
        return next(it)

    trainer.validate = validate
    ds = trainer.train_dataset
    set_epoch = type(ds).set_epoch

    def spy(epoch):
        events["set_epoch"].append(epoch)
        set_epoch(ds, epoch)

    ds.set_epoch = spy


# First pass: one tuning epoch a combo. Second: the tuner resumes each
# combo from its epoch_0, then the main loop stops at patience 2.
PASS_1 = [3.0, 2.0]
PASS_2 = [2.5, 1.5, 5.0, 4.0, 4.5, 3.0, 3.5, 3.6, 7.0]


class _PickleCheckpointer:
    def save(self, path, tree):
        path.mkdir(parents=True)
        (path / "tree.pkl").write_bytes(pickle.dumps(tree))

    def restore(self, path, item=None):
        return pickle.loads((path / "tree.pkl").read_bytes())


def _control_run(monkeypatch, tmp_path, package, corpus, jax_params=None):
    if package == "jax":
        mod, ckpt_mod, cfg_cls, ds_cls = jax_trainer, jax_checkpoint, JaxTrainerConfig, JaxDataset

        def params_of(state):
            return state._replace(step=state.step + 1)

        def fake_init(model, optimizer, rng, shape):
            params = jax.tree.map(jnp.asarray, jax_params)
            return JaxTrainState(params=params, opt_state=optimizer.init(params), step=jnp.zeros((), jnp.int32))

        monkeypatch.setattr(mod, "create_train_state", fake_init)
        # Orbax costs ~0.5 s a save here; the manager's own logic (swap,
        # rename, sidecars, latest_epoch_name) runs over pickle instead.
        monkeypatch.setattr(ckpt_mod, "_make_handler", lambda: None)
        monkeypatch.setattr(ckpt_mod.ocp, "Checkpointer", lambda handler: _PickleCheckpointer())
        model = JaxAutoencoder.create(**SMALL)
        make, loss_of = JaxTrainer, jnp.float32
    else:
        mod, ckpt_mod, cfg_cls, ds_cls = pt_trainer, pt_checkpoint, TrainerConfig, NSynthDataset

        def params_of(state):
            state.step += 1
            return state

        model = AudioAutoencoder.create(**SMALL, num_samples=T, device="cpu")
        make = Trainer

        def loss_of(n):
            return torch.tensor(float(n))

    root = tmp_path / package
    events, holder = _instrument(monkeypatch, mod, ckpt_mod, root, params_of, loss_of)
    train, val = _datasets(corpus, ds_cls)
    test = ds_cls(corpus[2][:3], train=False)
    kw = dict(max_epochs=10, patience=2, checkpoint_every_epochs=2)
    t1 = make(model, train, val, config=_config(root, cfg_cls, **kw))
    holder["trainer"] = t1
    _script(t1, events, PASS_1)
    best_1 = t1.tune_hyperparameters(GRID)
    t1.finish_checkpoints()
    events["pass_2"] = len(events["steps"])
    t2 = make(model, train, val, test,
              config=_config(root, cfg_cls, tuning_epochs=2, checkpoint_every_iters=2, **kw))
    holder["trainer"] = t2
    _script(t2, events, PASS_2)
    metrics = t2.train(GRID)
    sidecars = {}
    for p in sorted(root.rglob("*.extra.json")):
        extra = json.loads(p.read_text())
        sidecars[str(p.relative_to(root))] = {
            "keys": sorted(extra), "train_state": sorted(extra.get("train_state", {})),
            "model": extra.get("model"), "hyper": [extra[k] for k in GRID],
            "metrics": extra.get("train_state", {}).get("metrics"),
        }
    return dict(
        events=events, best_1=best_1, metrics=metrics.__dict__, sidecars=sidecars,
        metrics_json=json.loads((root / "metrics.json").read_text()),
        log=[json.loads(line) for line in (root / "train_log.jsonl").read_text().splitlines()],
        top=sorted(p.name for p in root.iterdir()),
        combos=sorted(p.name for p in root.iterdir() if p.name.startswith("e0")),
    )


def test_control_flow_matches_jax(monkeypatch, tmp_path, corpus):
    jax_params = flax_params(JaxAutoencoder.create(**SMALL), num_samples=T)
    want = _control_run(monkeypatch, tmp_path, "jax", corpus, jax_params)
    got = _control_run(monkeypatch, tmp_path, "torch", corpus)
    ev, jev = got["events"], want["events"]
    # The step calls: index batches, temperatures, step counters, combos.
    assert len(ev["steps"]) == len(jev["steps"]) == 4 * (2 + 2 + 6)
    for i, (a, b) in enumerate(zip(ev["steps"], jev["steps"])):
        assert a == b, i
    # Pass 2 resumed every combo from its epoch_0 (step counter 4 = one
    # epoch of 4 steps), with that combo's hyperparameters.
    resumed = jev["steps"][jev["pass_2"]]
    assert resumed[2] == 4 and resumed[3]["encoder_lr"] == GRID["encoder_lr"][0]
    assert ev["set_epoch"] == jev["set_epoch"] == list(range(6))
    assert ev["validate"] == jev["validate"] == ["val"] * 10 + ["test"]
    assert ev["saves"] == jev["saves"]
    assert (".", "best_tuning") in ev["saves"] and (".", "epoch_2_iter_2") in ev["saves"]
    assert got["best_1"] == want["best_1"] == {"encoder_lr": 5e-4, "decoder_lr": 1e-4, "complexity_penalty": 0.1}
    # Early stopping at patience 2: the run stops after epoch 5.
    assert got["metrics"] == want["metrics"]
    assert len(got["metrics"]["val_losses"]) == 6 and got["metrics"]["best_epoch"] == 3
    assert got["metrics_json"] == want["metrics_json"]
    assert got["sidecars"] == want["sidecars"]
    assert set(got["sidecars"]["latest.extra.json"]["train_state"]) == {"dataset_epoch", "epoch", "metrics",
                                                                          "rng_key"}
    assert got["log"] == want["log"]
    assert got["top"] == want["top"] and got["combos"] == want["combos"] == ["e0.0005_d0.0001_c0.1",
                                                                             "e0.001_d0.0001_c0.1"]


def test_train_log_record_keys_match_jax(tmp_path, model, corpus):
    """A real epoch's train_log.jsonl records carry the keys the JAX
    trainer writes: the step, the loss components of JAX's
    autoencoder_loss and JAX's per-component gradient norms."""
    train, val = _datasets(corpus, config=G3)
    trainer = Trainer(model, train, val, config=_config(tmp_path, with_grad_norms=True, log_every=1, batch_size=4))
    trainer.state = trainer.init_state()
    trainer.train_epoch(0)
    records = [json.loads(line) for line in (tmp_path / "train_log.jsonl").read_text().splitlines()]
    assert len(records) == len(train) // 4

    x = jnp.zeros((2, 1, T))
    aux = {k: jnp.zeros(2) for k in ("binary_entropy", "diversity", "l0")}
    _, components = jax.eval_shape(
        lambda: jax_autoencoder_loss(x, x, aux, jnp.ones(2, bool), contrastive=jnp.float32(1.0)))
    components = {k: 0.0 for k in components}
    params = flax_params(JaxAutoencoder.create(**SMALL), num_samples=T)
    norms = jax_grad_norms(jax.tree.map(jnp.asarray, params))
    JaxMetricWriter(tmp_path / "jax").write(1, {**components, "grad_norms": norms})
    want = json.loads((tmp_path / "jax" / "train_log.jsonl").read_text())
    for record in records:
        assert set(record) == set(want)
        assert set(record["grad_norms"]) == set(want["grad_norms"])
        assert all(np.isfinite(v) for k, v in record.items() if k != "grad_norms")


def test_validate_matches_jax(tmp_path, corpus):
    """validate on the same parameters (converted with state_dict_from_flax),
    over a val set whose last batch is short (5 clips at batch 2), through
    the array path and the indexed path."""
    jm = JaxAutoencoder.create(**TINY)
    params = flax_params(jm, num_samples=T)
    clips = waveforms(31, 13, T)[:, 0]
    train_clips, val_clips = clips[:8], clips[8:]
    neighbors = np.argsort(np.abs(np.arange(8)[:, None] - np.arange(8)[None]), axis=1, kind="stable")[:, 1:]
    jt = JaxTrainer(jm, JaxDataset(train_clips, neighbors, train=True), JaxDataset(val_clips),
                    config=_config(tmp_path / "jax", JaxTrainerConfig))
    jt.state = JaxTrainState(params=jax.tree.map(jnp.asarray, params), opt_state=None, step=jnp.int32(0))
    want_indexed = jt._validate_indexed(jt.val_dataset)
    jt.cfg.device_corpus = False
    want_array = jt.validate()

    pm = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu")
    pt = Trainer(pm, NSynthDataset(train_clips, neighbors, train=True), NSynthDataset(val_clips),
                 config=_config(tmp_path / "torch"))
    pt.state = pt.init_state()
    pm.load_state_dict(state_dict_from_flax(params, pm.state_dict()))
    got_indexed = pt.validate()
    pt.cfg.device_corpus = False
    got_array = pt.validate()
    np.testing.assert_allclose(want_indexed, want_array, rtol=1e-6)
    np.testing.assert_allclose(got_indexed, want_indexed, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got_array, want_array, rtol=LOSS_RTOL)
    # Every clip counts once: batch 1 covers the set exactly.
    pt1 = Trainer(pm, pt.train_dataset, pt.val_dataset, config=_config(tmp_path / "b1", batch_size=1))
    pt1.state = pt.state
    np.testing.assert_allclose(pt1.validate(), got_indexed, rtol=1e-6)


# ---------------------------------------------------------------- the port's own guarantees


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def test_kill_and_resume_is_bit_identical(tmp_path, model, corpus):
    """A run killed after 2 epochs and resumed reproduces the uninterrupted
    3-epoch run bit for bit: losses, best epoch, parameters and optimizer
    state. Accumulation 3 over 4 steps an epoch leaves the accumulator
    mid-cycle in the checkpoint, and the negative-sampling curriculum
    decays at every epoch (offsets 7, 4, 2), so a resume that reset it
    would sample other negatives."""
    cc = ContrastiveConfig(num_negative_samples=3, min_negative_offset=2, offset_decay_rate=0.5)
    train, val = _datasets(corpus, config=cc)
    kw = dict(accumulate_grad_batches=3, dump_audio=True, log_every=3)
    full = Trainer(model, train, val, config=_config(tmp_path / "full", max_epochs=3, **kw))
    m_full = full.train()
    assert train.current_negative_offset == 2
    want = _params(model)
    want_opt = full.state.opt_state

    train.set_epoch(0)
    Trainer(model, train, val, config=_config(tmp_path / "kill", max_epochs=2, **kw)).train()
    saved = CheckpointManager(tmp_path / "kill").restore("latest")["opt_state"]
    assert saved["mini_step"] == 2 and len(saved["acc"]) == len(want)
    train.set_epoch(0)
    model.reset_parameters(0)  # a fresh process: nothing survives but the files
    resumed = Trainer(model, train, val, config=_config(tmp_path / "kill", max_epochs=3, **kw))
    m_res = resumed.train(resume=True)
    assert m_res.val_losses == m_full.val_losses and len(m_res.val_losses) == 3
    assert m_res.train_losses == m_full.train_losses
    assert m_res.iteration_losses == m_full.iteration_losses
    assert m_res.best_epoch == m_full.best_epoch
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
    opt = resumed.state.opt_state
    assert (opt.count, opt.mini_step) == (want_opt.count, want_opt.mini_step)
    for n in want:
        assert torch.equal(opt.mu[n], want_opt.mu[n]) and torch.equal(opt.nu[n], want_opt.nu[n]), n
    assert sorted(p.name for p in (tmp_path / "kill" / "samples").iterdir()) == [
        f"epoch_{e}_iter_{i}" for e in range(3) for i in (0, 3)]


def test_scanned_epoch_equals_per_step(tmp_path, model, corpus):
    """scan_steps=3 runs the per-step trajectory exactly on the CPU, and
    writes the same log records."""
    train, val = _datasets(corpus, config=G3)
    runs = {}
    for name, scan in (("loop", 0), ("scan", 3)):
        train.set_epoch(0)
        trainer = Trainer(model, train, val,
                          config=_config(tmp_path / name, scan_steps=scan, accumulate_grad_batches=2,
                                         with_grad_norms=True))
        assert (trainer.scan_train_step is not None) == (scan == 3)
        trainer.state = trainer.init_state()
        trainer.train_epoch(0)
        trainer.train_epoch(1)
        runs[name] = (trainer.metrics.iteration_losses, _params(model), trainer.state.step,
                      (tmp_path / name / "train_log.jsonl").read_text().splitlines())
    (loss_a, params_a, step_a, log_a), (loss_b, params_b, step_b, log_b) = runs["loop"], runs["scan"]
    assert loss_a == loss_b and step_a == step_b == 8
    assert all(torch.equal(params_a[n], params_b[n]) for n in params_a)
    assert [json.loads(x) for x in log_a] == [json.loads(x) for x in log_b]


def test_indexed_steps_equal_the_array_step(model, corpus):
    """The corpus-indexed step (and its scanned form) gathers the batch the
    array step is given and takes the same step."""
    train, _ = _datasets(corpus, config=G3)
    idx = np.stack([train.sample_batch_indices(np.array([0, 5]), 7), train.sample_batch_indices(np.array([3, 1]), 8)])
    runs = []
    for kind in ("array", "indexed", "scan"):
        model.reset_parameters(3)
        opt = make_optimizer(accumulate_grad_batches=1)
        state = pt_trainer.create_train_state(model, opt)
        if kind == "array":
            step = make_train_step(model, opt)
            for i in range(2):
                state, m = step(state, torch.from_numpy(train.waveforms[idx[i]][:, :, None, :]), 1.0, 5)
            losses = [float(m["total_loss"])]
        elif kind == "indexed":
            step = make_indexed_train_step(model, opt, train.waveforms)
            for i in range(2):
                state, m = step(state, idx[i], 1.0, 5)
            losses = [float(m["total_loss"])]
        else:
            state, m = make_scan_indexed_train_step(model, opt, train.waveforms)(state, torch.from_numpy(idx), 1.0, 5)
            assert m["total_loss"].shape == (2,)
            losses = [float(m["total_loss"][1])]
        runs.append((losses, _params(model), state.step))
    for losses, params, step in runs[1:]:
        assert losses == runs[0][0] and step == 2
        assert all(torch.equal(params[n], runs[0][1][n]) for n in params)


def test_async_snapshot_is_isolated(tmp_path, model, corpus):
    """An async (block=False) save captures the state at call time: the
    next epoch's in-place updates do not reach it."""
    train, val = _datasets(corpus, config=G3)
    trainer = Trainer(model, train, val, config=_config(tmp_path))
    trainer.state = trainer.init_state()
    trainer.train_epoch(0)
    at_save = _params(model)
    mu_at_save = {n: t.clone() for n, t in trainer.state.opt_state.mu.items()}
    trainer.save_checkpoint("snap", epoch=0, block=False)
    trainer.train_epoch(1)
    trainer.finish_checkpoints()
    assert not all(torch.equal(p.detach(), at_save[n]) for n, p in model.named_parameters())

    t2 = Trainer(model, train, val, config=_config(tmp_path))
    extra = t2.load_checkpoint("snap")
    assert extra["train_state"]["epoch"] == 0
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), at_save[n]), n
        assert torch.equal(t2.state.opt_state.mu[n], mu_at_save[n]), n


def test_async_save_error_is_raised(tmp_path, model, corpus, monkeypatch):
    train, val = _datasets(corpus, config=G3)
    trainer = Trainer(model, train, val, config=_config(tmp_path))
    trainer.state = trainer.init_state()

    def fail(self, name, state, extra=None):
        raise OSError("disk full")

    monkeypatch.setattr(CheckpointManager, "save", fail)
    trainer.save_checkpoint("snap", block=False)
    with pytest.raises(OSError, match="disk full"):
        trainer.finish_checkpoints()
    trainer.finish_checkpoints()  # raised once, then cleared


def test_checkpoint_swap_fallback_and_layout(tmp_path):
    """A crash between the old checkpoint's removal and the swap rename
    leaves a complete ``<name>.swap`` that exists/restore fall back to; an
    incomplete swap (no state file) is never read. The sidecar sits next
    to the state; the legacy in-dir extra.json is read; latest_epoch_name
    skips the sidecars."""
    ckpt = CheckpointManager(tmp_path / "ck")
    ckpt.save("latest", {"a": np.arange(3), "n": 4, "t": torch.ones(2, dtype=torch.bfloat16)}, extra={"k": 1})
    assert (tmp_path / "ck" / "latest" / "state.pt").exists()
    assert json.loads((tmp_path / "ck" / "latest.extra.json").read_text()) == {"k": 1}
    (tmp_path / "ck" / "latest").rename(tmp_path / "ck" / "latest.swap")  # the crash
    assert ckpt.exists("latest")
    restored = ckpt.restore("latest")
    assert torch.equal(restored["a"], torch.arange(3)) and restored["n"] == 4
    assert restored["t"].dtype == torch.bfloat16
    (tmp_path / "ck" / "half.swap").mkdir()  # a crash mid-write of the first save
    assert not ckpt.exists("half")
    ckpt.save("epoch_3", {"a": np.zeros(1)}, extra={"e": 3})
    ckpt.save("epoch_12", {"a": np.zeros(1)})
    ckpt.save("epoch_12_iter_5", {"a": np.zeros(1)})
    assert ckpt.latest_epoch_name() == "epoch_12"
    (tmp_path / "ck" / "old").mkdir()
    (tmp_path / "ck" / "old" / "extra.json").write_text('{"legacy": true}')
    assert ckpt.load_extra("old") == {"legacy": True} and ckpt.load_extra("none") is None
    like = ckpt.restore("epoch_3", template={"a": torch.zeros(1)})
    assert ckpt.restore("epoch_3")["a"].dtype == torch.float64 and like["a"].dtype == torch.float32
    with pytest.raises(KeyError):
        ckpt.restore("epoch_3", template={"b": torch.zeros(1)})


def test_save_and_load_params(tmp_path, model):
    save_params(tmp_path, model.state_dict())
    template = {k: torch.zeros_like(v) for k, v in model.state_dict().items()}
    loaded = load_params(tmp_path, template)
    assert loaded.keys() == template.keys()
    assert all(torch.equal(loaded[k], v) for k, v in model.state_dict().items())


def test_checkpoint_moments_bf16_roundtrip(tmp_path, model, corpus):
    """checkpoint_moments_bf16 stores every float tensor of the optimizer
    state in bfloat16 (stamped in the sidecar) and restores them to the
    live dtypes; params round-trip bit for bit; training goes on."""
    train, val = _datasets(corpus, config=G3)
    cfg = _config(tmp_path, checkpoint_moments_bf16=True, accumulate_grad_batches=3)
    trainer = Trainer(model, train, val, config=cfg)
    trainer.state = trainer.init_state()
    trainer.train_epoch(0)  # 4 steps: one update, one gradient accumulated
    trainer.save_checkpoint("m16", epoch=0)
    raw = CheckpointManager(tmp_path).restore("m16")
    assert json.loads((tmp_path / "m16.extra.json").read_text())["moments_dtype"] == "bfloat16"
    opt = raw["opt_state"]
    on_disk = [t.dtype for k in ("mu", "nu", "acc") for t in opt[k].values()]
    assert len(on_disk) == 3 * len(opt["mu"]) and set(on_disk) == {torch.bfloat16}
    assert {t.dtype for t in raw["params"].values()} == {torch.float32}

    live = trainer.state.opt_state
    want = _params(model)
    t2 = Trainer(model, train, val, config=cfg)
    model.reset_parameters(1)
    t2.load_checkpoint("m16")
    rest = t2.state.opt_state
    assert (rest.count, rest.mini_step) == (live.count, live.mini_step) == (1, 1)
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), want[n]), n
        for a, b in ((live.mu[n], rest.mu[n]), (live.nu[n], rest.nu[n]), (live.acc[n], rest.acc[n])):
            assert b.dtype == a.dtype == torch.float32
            torch.testing.assert_close(b, a, rtol=8e-3, atol=1e-6)
    t2.train_epoch(1)
    assert all(np.isfinite(t2.metrics.iteration_losses))


def test_val_corpus_cache_does_not_key_on_id(tmp_path, model, corpus, monkeypatch):
    """The indexed validate keeps the device corpus for the dataset it came
    from, held by a weak reference: another dataset gets its own corpus,
    even where it shares the first one's ``id``. Every ``id`` in the
    trainer's module is made to collide (as an address reused after the
    first dataset is freed would), and must not matter."""
    train, _ = _datasets(corpus, config=G3)
    clips = [synth_corpus(3, n_samples=T, seed=s) for s in (10, 11)]
    ref = Trainer(model, train, NSynthDataset(clips[1]), config=_config(tmp_path / "ref"))
    ref.state = ref.init_state()
    want = ref.validate()

    monkeypatch.setattr(pt_trainer, "id", lambda obj: 0, raising=False)
    trainer = Trainer(model, train, NSynthDataset(clips[0]), config=_config(tmp_path / "t"))
    trainer.state = ref.state
    ds = NSynthDataset(clips[0])
    first = trainer.validate(ds)
    assert trainer._val_corpus_ref() is ds
    del ds
    gc.collect()
    assert trainer._val_corpus_ref() is None  # the cache does not keep its dataset alive
    got = trainer.validate(NSynthDataset(clips[1]))
    assert got == want and got != first


def test_data_parallel_config_errors(tmp_path, model, corpus, monkeypatch):
    """The JAX Trainer's two ValueErrors, with its messages: a batch that
    does not divide over the mesh (here a stand-in mesh of two ranks), and
    shard_corpus without data_parallel and device_corpus."""
    from topo_audio_autoencoder_torch.parallel import DataMesh

    train, val = _datasets(corpus, config=G3)
    two = DataMesh(group=None, rank=0, size=2, device=torch.device("cpu"), backend="gloo")
    monkeypatch.setattr(pt_trainer, "make_mesh", lambda n_devices=None, device=None: two)
    with pytest.raises(ValueError, match="must divide the 2-device mesh"):
        Trainer(model, train, val, config=_config(tmp_path, batch_size=3, data_parallel=True))
    for kw in (dict(shard_corpus=True), dict(shard_corpus=True, data_parallel=True, device_corpus=False)):
        with pytest.raises(ValueError, match="shard_corpus requires data_parallel and device_corpus"):
            Trainer(model, train, val, config=_config(tmp_path, **kw))


def test_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path, model, corpus, monkeypatch):
    train, val = _datasets(corpus, config=G3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, train, val, config=_config(tmp_path, device=None))
