"""PyTorch port vs the JAX package: the vmapped grid tuner at the tiny
config on the CPU.

Both packages start every combo from the same parameters and feed it the
same sampler uniforms: the test derives the uniforms JAX's ``loss_fn``
draws from each combo's key (split -> split -> uniform) and hands them to
the port. Dropout is off in the parity cases (flax's dropout stream cannot
be reproduced in torch, as in test_torch_training.py); the port's own
dropout noise goes through the scanned-vs-per-step case and
``test_dropout_noise_equals_the_generator_draw``.

One JAX grid step is compiled, with an optimizer that only records the
gradients it is given, over K = 4 combos: two that train on the real loss
(different parameters, learning rates and complexity penalties) and their
two twins, marked by a negative complexity penalty, on a surrogate
objective (the spectral distance replaced by a fixed linear functional of
the reconstruction, well conditioned: see test_torch_training.py). The
same loss replacement is patched into both packages' tuner modules.
"""

import copy
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_parity import TINY, flax_params, waveforms

import topo_audio_autoencoder_torch.training.tuner as pt_tuner
import topo_audio_autoencoder_tpu.training.tuner as jax_tuner
from topo_audio_autoencoder_torch.convert import state_dict_from_flax
from topo_audio_autoencoder_torch.data import NSynthDataset, compute_distances, index_iterator, synth_corpus
from topo_audio_autoencoder_torch.models import AudioAutoencoder
from topo_audio_autoencoder_torch.models.decoder import linear_resize, masked_linear_resize
from topo_audio_autoencoder_torch.ops import attention
from topo_audio_autoencoder_torch.ops.attention import MaskedAttention
from topo_audio_autoencoder_torch.topology.complexes import build_tables
from topo_audio_autoencoder_torch.topology.rectifier import _FaceGather, face_adjoints, face_indices
from topo_audio_autoencoder_torch.training import (
    OptState,
    Trainer,
    TrainerConfig,
    VmappedGridTuner,
    make_loss_and_grads,
    make_optimizer,
)
from topo_audio_autoencoder_tpu.models import AudioAutoencoder as JaxAutoencoder

torch.set_num_threads(1)

T = 2048  # the port refuses clips of 1,024 samples or fewer
B, G = 2, 3
TEMPERATURE = 1.0
# Two real combos and their surrogate twins (negative penalty).
ENC_LR = [1e-3, 5e-4, 1e-3, 5e-4]
DEC_LR = [1e-4, 2e-4, 1e-4, 2e-4]
CPX = [0.1, 0.3, -1.0, -1.0]
PARAM_SEEDS = [1, 2, 1, 2]
REAL = [0, 1]
# tests/test_tuner.py's model, for the whole tunes.
SMALL = dict(num_vertices=4, num_bands=4, sccn_hidden_dim=8, n_sccn_layers=1)
LOSS_RTOL = 1e-4
# The real loss's gradient as a whole (relative L2), as test_torch_training.py
# holds the train step's. Measured: 2.6e-3 and 1.4e-3 against JAX; 2.4e-3
# and 2.1e-4 against the port's single-combo step (FFT spectral term).
GRAD_REL_L2 = 1e-2
# Every surrogate gradient leaf, relative to its largest element. Measured:
# 7.9e-6 and 5.5e-6.
SURROGATE_RTOL = 1e-4


def _surrogate_or_real(real_loss, w, xp):
    """``autoencoder_loss`` for the tuner modules: the real loss, or, where
    the combo's complexity penalty is negative, <recon, w> + contrastive +
    the regularizers."""

    def loss(recon, target, aux, valid, weights, contrastive=None, **kw):
        total, comps = real_loss(recon, target, aux, valid, weights, contrastive, **kw)
        sur = (recon * w).sum() + aux["binary_entropy"].mean() + aux["diversity"].mean()
        if contrastive is not None:
            sur = sur + contrastive
        return xp.where(weights.complexity_penalty < 0, sur, total), comps

    return loss


def _record():
    """An optax transformation that applies nothing and keeps the gradient
    it was given in its state."""

    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        return jax.tree.map(jnp.zeros_like, updates), {"g": updates}

    return optax.GradientTransformation(init, update)


def _combo_noise(rngs, shape):
    """The uniforms each combo's JAX ``loss_fn`` draws for its sampler."""
    out = []
    for rng in rngs:
        srng, _ = jax.random.split(rng)
        sample_rng, _ = jax.random.split(srng)
        out.append(np.array(jax.random.uniform(sample_rng, shape, minval=1e-6, maxval=1.0 - 1e-6)))
    return np.stack(out)


def _port_state(trees, template, device="cpu"):
    """A port GridState over flax-layout parameter trees, one per combo."""
    sds = [state_dict_from_flax(t, template) for t in trees]
    params = {n: torch.stack([sd[n] for sd in sds]).to(device) for n in sds[0]}
    opt = OptState(mu={n: torch.zeros_like(p) for n, p in params.items()},
                   nu={n: torch.zeros_like(p) for n, p in params.items()})
    return pt_tuner.GridState(params, opt, *(torch.tensor(v, dtype=torch.float32) for v in (ENC_LR, DEC_LR, CPX)))


def _l2(tensors) -> float:
    return float(np.sqrt(sum(float((t.double() ** 2).sum()) for t in tensors)))


@pytest.fixture(scope="module")
def run():
    jm = JaxAutoencoder.create(**TINY, dropout=0.0)
    trees = [flax_params(jm, seed=s, num_samples=T) for s in PARAM_SEEDS]
    batch = waveforms(5, B * G, T).reshape(B, G, 1, T)
    w = np.random.default_rng(7).standard_normal((B, 1, T)).astype(np.float32)
    rngs = jax.random.split(jax.random.PRNGKey(3), len(CPX))
    with mock.patch.object(optax, "chain", lambda *a: _record()), mock.patch.object(
        jax_tuner, "autoencoder_loss", _surrogate_or_real(jax_tuner.autoencoder_loss, jnp.asarray(w), jnp)
    ):
        tuner = jax_tuner.VmappedGridTuner(jm)
        params = jax.tree.map(lambda *leaves: jnp.asarray(np.stack(leaves)), *trees)
        state = jax_tuner.GridState(params, jax.vmap(tuner.tx.init)(params),
                                    *(jnp.asarray(v, jnp.float32) for v in (ENC_LR, DEC_LR, CPX)))
        new, losses = tuner.grid_step(state, jnp.asarray(batch), jnp.asarray(TEMPERATURE, jnp.float32), rngs)
    return dict(
        model=jm, trees=trees, batch=batch, w=w, losses=np.asarray(losses),
        grads=jax.tree.map(np.asarray, new.opt_state["g"]),
        noise=_combo_noise(rngs, (B, jm.tables.total_simplices)),
    )


@pytest.fixture(scope="module")
def port(run):
    """The port's grid step on the same parameters, batch and uniforms."""
    pm = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu", dropout=0.0)
    template = pm.state_dict()
    tuner = VmappedGridTuner(pm)
    state = _port_state(run["trees"], template)
    loss = _surrogate_or_real(pt_tuner.autoencoder_loss, torch.from_numpy(run["w"]), torch)
    with mock.patch.object(pt_tuner, "autoencoder_loss", loss):
        losses, grads = tuner.loss_and_grads(state, torch.from_numpy(run["batch"]), TEMPERATURE,
                                             noise={"noise": torch.from_numpy(run["noise"])})
    return dict(model=pm, template=template, tuner=tuner, losses=losses, grads=grads)


def _jax_grads(run, template, k):
    tree = jax.tree.map(lambda g: g[k], run["grads"])
    return state_dict_from_flax(tree, template)


def test_grid_step_losses_match_jax(run, port):
    np.testing.assert_allclose(port["losses"].numpy()[REAL], run["losses"][REAL], rtol=LOSS_RTOL)
    assert np.all(np.isfinite(port["losses"].numpy()))


@pytest.mark.parametrize("k", REAL)
def test_grid_step_gradient_matches_jax(run, port, k):
    want = _jax_grads(run, port["template"], k)
    got = {n: g[k] for n, g in port["grads"].items()}
    assert got.keys() == want.keys()
    err = _l2(got[n] - want[n] for n in want) / _l2(want.values())
    assert err <= GRAD_REL_L2, err


@pytest.mark.parametrize("k", [2, 3])
def test_every_surrogate_gradient_leaf_matches_jax(run, port, k):
    np.testing.assert_allclose(float(port["losses"][k]), float(run["losses"][k]), rtol=LOSS_RTOL)
    want = _jax_grads(run, port["template"], k)
    got = {n: g[k] for n, g in port["grads"].items()}
    scale = max(float(g.abs().max()) for g in want.values())
    worst = max((float((got[n] - want[n]).abs().max()) / scale, n) for n in want)
    assert worst[0] <= SURROGATE_RTOL, worst


def test_grid_equals_single_combo_steps(run, port):
    """Each real combo's grid loss and gradient against the port's own
    single-combo train step on the same parameters and uniforms (which
    computes the spectral term by FFT, the tuner by the matmul DFT); the
    stacked update against the port's two-group Optimizer on that combo's
    grid gradient."""
    tuner, template = port["tuner"], port["template"]
    state = _port_state(run["trees"][:2], template)
    state.encoder_lr, state.decoder_lr, state.complexity_penalty = (
        torch.tensor(v[:2]) for v in (ENC_LR, DEC_LR, CPX))
    batch = torch.from_numpy(run["batch"])
    noise = torch.from_numpy(run["noise"][:2])
    losses, grads = tuner.loss_and_grads(state, batch, TEMPERATURE, noise={"noise": noise})
    tuner.apply_updates(state, grads)
    for k in range(2):
        single = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu", dropout=0.0,
                                         use_fused_sampler=False)
        single.load_state_dict(state_dict_from_flax(run["trees"][k], template))
        weights = pt_tuner.LossWeights(complexity_penalty=CPX[k])
        total, _, want = make_loss_and_grads(single, weights)(batch, TEMPERATURE, 0, 0, noise[k])
        np.testing.assert_allclose(float(losses[k]), float(total), rtol=LOSS_RTOL)
        got = {n: g[k] for n, g in grads.items()}
        assert _l2(got[n] - want[n] for n in want) / _l2(want.values()) <= GRAD_REL_L2
        opt = make_optimizer(ENC_LR[k], DEC_LR[k], accumulate_grad_batches=1)
        opt.update(got, opt.init(single), single)
        for n, p in single.named_parameters():
            torch.testing.assert_close(state.params[n][k], p.detach(), rtol=0, atol=1e-7, msg=n)


def test_stacked_optimizer_matches_optax(port):
    """clip_by_global_norm (each combo over its own leaves) -> scale_by_adam
    -> -lr per group, over two steps, against optax on the same gradients:
    one combo's gradient far above the clip norm, one below."""
    rng = np.random.default_rng(11)
    # Encoder and decoder leaves, a 0-d one among them (stacked to [K]).
    shapes = {"encoder.mlp0.weight": (6, 5), "encoder.skip_weight": (), "encoder.embed_rank1": (4, 3),
              "decoder.tconv0.bias": (7,), "decoder.attention_scale": (), "decoder.up0_norm.weight": (2, 3, 4)}
    names = list(shapes)
    p0 = {n: rng.standard_normal((2, *s)).astype(np.float32) for n, s in shapes.items()}
    tuner = port["tuner"]
    state = pt_tuner.GridState(
        {n: torch.from_numpy(v.copy()) for n, v in p0.items()},
        OptState(mu={n: torch.zeros(2, *s) for n, s in shapes.items()},
                 nu={n: torch.zeros(2, *s) for n, s in shapes.items()}),
        torch.tensor([1e-3, 5e-4]), torch.tensor([1e-4, 2e-4]), torch.tensor([0.1, 0.1]))
    tx = optax.chain(optax.clip_by_global_norm(10.0), optax.scale_by_adam())
    want = {n: jnp.asarray(v) for n, v in p0.items()}
    opt_state = jax.vmap(tx.init)(want)
    enc = {n: n.startswith("encoder.") for n in names}

    def apply_one(params, st, lr_e, lr_d, grads):
        updates, st = tx.update(grads, st, params)
        return {n: params[n] - (lr_e if enc[n] else lr_d) * updates[n] for n in names}, st

    step_fn = jax.jit(jax.vmap(apply_one))
    for step in range(2):
        scale = np.float32([100.0, 1e-3])  # combo 0 clipped, combo 1 not
        g = {n: rng.standard_normal((2, *s)).astype(np.float32) * scale.reshape(2, *[1] * len(s))
             for n, s in shapes.items()}
        want, opt_state = step_fn(want, opt_state, jnp.asarray([1e-3, 5e-4]),
                                              jnp.asarray([1e-4, 2e-4]), {n: jnp.asarray(v) for n, v in g.items()})
        tuner.apply_updates(state, {n: torch.from_numpy(v) for n, v in g.items()})
        for n in names:
            np.testing.assert_allclose(state.params[n].numpy(), np.asarray(want[n]), rtol=0, atol=1e-6, err_msg=n)
    assert state.opt_state.count == 2
    # The moments to 1e-6 of their largest element: the global norms sum the
    # leaves in other orders, so a clipped gradient moves by an ulp or two.
    for n in names:
        for got, want in ((state.opt_state.mu[n], opt_state[1].mu[n]), (state.opt_state.nu[n], opt_state[1].nu[n])):
            want = np.asarray(want)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max(), err_msg=n)


@pytest.fixture(scope="module")
def data():
    corpus = synth_corpus(6, T, seed=1)
    d = compute_distances(corpus, tile=6, scales=(256,), device="cpu")
    train = NSynthDataset(corpus, d["neighbors"], train=True)
    val = NSynthDataset(synth_corpus(4, T, seed=2), train=False)
    model = AudioAutoencoder.create(**SMALL, num_samples=T, device="cpu")
    return model, train, val


def test_scanned_tune_equals_per_step_bit_for_bit(data):
    """Two epochs through the device corpus, with dropout on: segments of 2
    grid steps against one step at a time. Every step's noise derives from
    (seed, combo, step), so the curves, val losses and parameters are
    equal."""
    model, train, val = data
    grid = {"encoder_lr": [1e-3], "decoder_lr": [1e-4], "complexity_penalty": [0.05, 0.1]}
    kw = dict(train_batches=lambda e: index_iterator(train, 2, epoch=e),
              val_batches=lambda: index_iterator(val, 2, shuffle=False),
              corpus=train.waveforms, val_corpus=val.waveforms, epochs=2, seed=7)
    step = VmappedGridTuner(model).tune(grid, **kw)
    scan = VmappedGridTuner(model).tune(grid, scan_steps=2, **kw)
    assert len(step["train_curve"]) == 6 and np.all(np.isfinite(step["train_curve"]))
    assert scan["train_curve"] == step["train_curve"]
    assert scan["val_losses"] == step["val_losses"] and scan["best_index"] == step["best_index"]
    for n, p in step["state"].params.items():
        assert torch.equal(p, scan["state"].params[n]), n


def test_vmapped_combos_diverge(data):
    """Different learning rates move their own combo's parameters by
    different amounts (the JAX test's check)."""
    model, train, val = data
    tuner = VmappedGridTuner(model)
    grid = {"encoder_lr": [1e-2, 1e-5], "decoder_lr": [1e-4], "complexity_penalty": [0.1]}
    state = tuner.init_grid(grid, (1, 1, T))
    name = next(n for n in state.params if n.startswith("encoder."))
    before = state.params[name].clone()
    batch = train.sample_batch(np.arange(2), 0)
    tuner.grid_step(state, batch, 1.0, seed=0)
    moved = (state.params[name] - before).abs().reshape(2, -1).mean(dim=1)
    assert moved[0] > moved[1] * 10
    assert not torch.equal(state.params[name][0], before[1])  # combos start from different seeds


def test_tune_picks_jax_best_index(data):
    """A whole tune (4 combos, 1 epoch through the device corpus) selects
    the combo whose val loss is lowest; JAX's grid_eval on the tuned
    parameters gives the same val losses (LOSS_RTOL) and the same winner."""
    model, train, val = data
    grid = {"encoder_lr": [1e-3, 5e-4], "decoder_lr": [1e-4], "complexity_penalty": [0.05, 2.0]}
    res = VmappedGridTuner(model).tune(
        grid, train_batches=lambda e: index_iterator(train, 2, epoch=e),
        val_batches=lambda: index_iterator(val, 2, shuffle=False),
        corpus=train.waveforms, val_corpus=val.waveforms, epochs=1, seed=3)
    assert res["best_index"] == int(np.argmin(res["val_losses"]))
    assert res["best_params"]["complexity_penalty"] == 0.05
    jmodel = JaxAutoencoder.create(**SMALL)
    shapes = jax.eval_shape(lambda: jmodel.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((1, 1, T)), 1.0, jax.random.PRNGKey(2), True))
    jeval = jax_tuner.VmappedGridTuner(jmodel).grid_eval
    jparams = _flax_stack(res["state"].params, shapes)
    cpx = jnp.asarray([c for _, _, c in jax_tuner._grid_combos(grid)], jnp.float32)
    jval = np.mean([np.asarray(jeval(jparams, cpx, jnp.asarray(val.sample_batch(np.arange(i, i + 2), 0))))
                    for i in range(0, len(val), 2)], axis=0)
    np.testing.assert_allclose(res["val_losses"], jval, rtol=LOSS_RTOL)
    assert int(np.argmin(jval)) == res["best_index"]


def _flax_stack(params: dict, shapes) -> dict:
    """The port's stacked {name: [K, ...]} parameters as a K-stacked flax
    tree shaped like ``shapes`` (``convert``'s mapping, inverted)."""

    def leaf(path, shape):
        *modules, last = path
        if last == "kernel":
            p = params[".".join((*modules, "weight"))]
            return p.transpose(1, 2) if len(shape.shape) == 2 else p.permute(0, 3, 2, 1)
        if last == "scale":
            return params[".".join((*modules, "weight"))]
        return params[".".join(path)]

    def walk(tree, path=()):
        return {k: walk(v, (*path, k)) if isinstance(v, dict) else jnp.asarray(leaf((*path, k), v).numpy())
                for k, v in tree.items()}

    return {"params": walk(shapes["params"])}


def test_trainer_vmapped_tuning_writes_best_tuning(data, tmp_path):
    """The JAX test's check: the tune selects a combo, the trainer adopts
    its parameters (a single, unstacked set) and saves best_tuning."""
    model, train, val = data
    trainer = Trainer(copy.deepcopy(model), train, val, config=TrainerConfig(
        checkpoint_dir=str(tmp_path), batch_size=2, accumulate_grad_batches=1, tuning_epochs=1,
        dump_audio=False, with_grad_norms=False, device="cpu"))
    grid = {"encoder_lr": [1e-3, 5e-4], "decoder_lr": [1e-4], "complexity_penalty": [0.1]}
    best = trainer.tune_hyperparameters_vmapped(grid)
    assert best is not None and best["encoder_lr"] in grid["encoder_lr"]
    assert trainer.metrics.best_params == best
    assert trainer.hyper == best
    assert trainer.state is not None and trainer.state.model is trainer.model
    fresh = dict(model.named_parameters())
    assert all(p.shape == fresh[n].shape for n, p in trainer.model.named_parameters())
    assert (tmp_path / "best_tuning" / "state.pt").exists()
    assert (tmp_path / "best_tuning.extra.json").exists()


def test_mesh_of_one_changes_no_bit(data):
    """The tuner on a data mesh of one process (gloo, a local store) equals
    the tuner without a mesh bit for bit, dropout on: the grid broadcast,
    the rank-row draws and the all-reduces of the gradients, losses and
    eval losses change nothing over one rank. (Two ranks:
    tests/test_torch_parallel.py.)"""
    from topo_audio_autoencoder_torch.parallel import make_mesh

    model, train, val = data
    grid = {"encoder_lr": [1e-3, 5e-4], "decoder_lr": [1e-4], "complexity_penalty": [0.1]}
    kw = dict(train_batches=lambda e: index_iterator(train, 2, epoch=e),
              val_batches=lambda: index_iterator(val, 2, shuffle=False),
              corpus=train.waveforms, val_corpus=val.waveforms, epochs=1, seed=7, scan_steps=2)
    want = VmappedGridTuner(model).tune(grid, **kw)
    mesh = make_mesh(1, device="cpu", timeout=60)
    try:
        got = VmappedGridTuner(model, mesh=mesh).tune(grid, **kw)
    finally:
        mesh.close()
    assert got["train_curve"] == want["train_curve"] and got["val_losses"] == want["val_losses"]
    for n, p in want["state"].params.items():
        assert torch.equal(got["state"].params[n], p), n


def test_dropout_noise_equals_the_generator_draw(data):
    """compute_logits with ``dropout_noise`` drawn from a generator equals
    the generator path bit for bit; the default path is unchanged."""
    model = AudioAutoencoder.create(**TINY, num_samples=T, device="cpu", dropout=0.3)
    bands = model.pqmf(torch.from_numpy(waveforms(4, 2, T))).transpose(-1, -2)
    want = model.encoder.compute_logits(bands, True, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(5)
    noise = (torch.rand((2, 2048), generator=gen), torch.rand((2, 1024), generator=gen))
    got = model.encoder.compute_logits(bands, True, dropout_noise=noise)
    assert torch.equal(got, want)
    assert not torch.equal(got, model.encoder.compute_logits(bands, False))


def _attention(k):
    rng = np.random.default_rng(k)
    q, kk, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).requires_grad_()
                for s in ((3, 2, 5, 8), (3, 2, 7, 8), (3, 2, 7, 8)))
    mask = torch.from_numpy((rng.uniform(size=(3, 2, 7)) > 0.4).astype(np.float32))
    mask[1, 0] = 0.0  # a fully masked element
    return (q, kk, v, mask), lambda q, kk, v, m: MaskedAttention.apply(q, kk, v, m, 2)


def _resize(k):
    x = torch.from_numpy(np.random.default_rng(k).standard_normal((3, 2, 9, 4)).astype(np.float32))
    return (x.requires_grad_(),), lambda x: linear_resize(x, 14)


def _masked_resize(k):
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((3, 2, 9, 4)).astype(np.float32)).requires_grad_()
    valid = torch.from_numpy(rng.integers(0, 10, (3, 2)))
    return (x, valid), lambda x, vl: masked_linear_resize(x, vl, 12)


def _face_gather(k):
    tables = build_tables(6)
    idx, adj = face_indices(tables, torch.device("cpu"))[1], face_adjoints(tables, torch.device("cpu"))[1]
    x = torch.from_numpy(np.random.default_rng(k).standard_normal((3, 2, tables.sizes[1])).astype(np.float32))
    return (x.requires_grad_(),), lambda x: _FaceGather.apply(x, idx, adj)


@pytest.mark.parametrize("make", [_attention, _resize, _masked_resize, _face_gather],
                         ids=["MaskedAttention", "_Resize", "_MaskedResize", "_FaceGather"])
def test_folded_vmap_rule_matches_unbatched_calls(make, monkeypatch):
    """vmap over K = 3 against K unbatched calls, element by element, in the
    forward and in the backward; the attention's forward and backward each
    run once, over K*B elements."""
    inputs, fn = make(0)
    calls = []
    for name in ("attention_fwd", "attention_bwd"):
        real = getattr(attention, name)
        monkeypatch.setattr(attention, name, lambda *a, _f=real, _n=name: calls.append((_n, a[0].shape[0])) or _f(*a))
    out = torch.func.vmap(fn, randomness="error")(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    cot = [torch.from_numpy(np.random.default_rng(9).standard_normal(o.shape).astype(np.float32)) for o in outs]
    diff = [t for t in inputs if t.requires_grad]
    got_grads = torch.autograd.grad(outs[0], diff, cot[0])
    if make is _attention:
        assert calls == [("attention_fwd", 6), ("attention_bwd", 6)]
    for k in range(3):
        one = fn(*(t[k] for t in inputs))
        ones = one if isinstance(one, tuple) else (one,)
        for a, b in zip(outs, ones):
            torch.testing.assert_close(a[k], b, rtol=0, atol=1e-6)
        want = torch.autograd.grad(ones[0], diff, cot[0][k])
        for g, w in zip(got_grads, want):
            torch.testing.assert_close(g[k], w[k], rtol=0, atol=1e-6)
