"""PyTorch port vs the JAX package: whole train steps of the Hard Concrete
models at the tiny config.

Two configurations of the repo's benchmarks, cut to the tiny width:

- ``hc_hard``: the fixed-stretch Hard Concrete sampler with the
  straight-through hard path, G=1 (no contrastive term), the default loss
  weights (BASELINE config 3's step);
- ``hc_learned``: the learned per-rank stretch, soft, G=3, with the
  expected-L0 term weighted 0.01 (the recipe's ``--learned-hc`` model).

As in test_torch_training.py, both packages start from the same
parameters and see the same batch and the same uniforms: the test derives
JAX's own keys (fold_in(key, step) -> split -> split) and hands the
relaxation's uniforms and, for the hard model, the four per-rank Bernoulli
uniforms to the port. Dropout is off. The loss is held tightly, the real
step's gradient as a whole, and every gradient leaf (the three [4] stretch
leaves included) through the surrogate objective of test_torch_training.py
(the spectral distance replaced by a fixed linear functional of the
reconstruction; see Conditioning there).

Mask flips. A gate whose pre-clip value lies within rounding of 0 is
exactly 0 in one package and ~1e-8 in the other, which turns an attention
key on or off; a uniform that close to its Bernoulli probability flips the
draw. Every gate and draw of these inputs is checked to clear
PARITY_MARGIN first, so a failure there names the margin, not the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    TINY,
    clip_margin,
    draw_margin,
    flax_params,
    hc_preclip,
    jax_hard_noise,
    port_model,
    waveforms,
)
from test_torch_training import _jax_surrogate, _leaves, _l2, _port_surrogate, _record_grads, jax_step_noise

from topo_audio_autoencoder_torch.training import (
    LossWeights,
    create_train_state,
    make_loss_and_grads,
    make_optimizer,
    make_train_step,
)
from topo_audio_autoencoder_tpu.models import AudioAutoencoder as JaxAutoencoder
from topo_audio_autoencoder_tpu.training import LossWeights as JaxLossWeights
from topo_audio_autoencoder_tpu.training import TrainState as JaxTrainState
from topo_audio_autoencoder_tpu.training import make_train_step as jax_make_train_step

torch.set_num_threads(1)

T = 2048
B = 2
RUN_SEED = 5
TEMPERATURE = 0.5
CONFIGS = {
    "hc_hard": dict(model=dict(sampler="hard_concrete", hard=True), group=1, l0=0.0),
    "hc_learned": dict(model=dict(sampler="hard_concrete", learned_hc=True), group=3, l0=0.01),
}
PARITY_MARGIN = 1e-4
# Loss and components: fp32 in both (test_torch_training.py measures 1e-6
# relative on the Gumbel model).
LOSS_RTOL = 1e-5
# The real step's gradient as a whole, relative L2 (test_torch_training.py:
# the spectral log term's round-off; measured there 1.9e-3 to 3.8e-3).
GRAD_REL_L2 = 1e-2
# Every surrogate gradient leaf, relative to the largest element.
SURROGATE_RTOL = 1e-4


def _jax_hard_noise(key, step, rect_shapes):
    """The four per-rank uniforms of the hard path's Bernoulli draws in
    JAX's train step: fold_in -> split (srng) -> split (hard_rng) -> 4."""
    srng, _ = jax.random.split(jax.random.fold_in(key, step))
    _, hard_rng = jax.random.split(srng)
    return jax_hard_noise(hard_rng, rect_shapes)


@pytest.fixture(scope="module", params=list(CONFIGS))
def run(request):
    cfg = CONFIGS[request.param]
    jm = JaxAutoencoder.create(**TINY, dropout=0.0, **cfg["model"])
    params = flax_params(jm, num_samples=T)
    g = cfg["group"]
    batch = waveforms(7, B * g, T).reshape(B, g, 1, T)
    key = jax.random.PRNGKey(RUN_SEED)
    record = _record_grads()
    jstep = jax_make_train_step(jm, record, JaxLossWeights(l0_penalty=cfg["l0"]), with_grad_norms=True,
                                donate=False)
    state = JaxTrainState(params=jax.tree.map(jnp.asarray, params), opt_state=record.init(params),
                          step=jnp.int32(0))
    new, metrics = jstep(state, jnp.asarray(batch), TEMPERATURE, key)

    # The anchors' biased logits and soft rectified latent, for the margins.
    anchors = jnp.asarray(batch[:, 0])
    enc = jax.jit(lambda p, x, r: jm.apply(p, x, TEMPERATURE, r, True,
                                           method=lambda m, x, t, r, tr: m.encode(x, t, r, tr)))(
        jax.tree.map(jnp.asarray, params), anchors, jax.random.split(jax.random.fold_in(key, 0))[0])
    biased = np.asarray(enc.logits).copy()
    biased[:, : jm.tables.num_vertices] += 2.0  # relu(vertex_bias)
    rect = [np.asarray(r) for r in enc.rectified]
    noise = np.array(jax_step_noise(key, 0, biased.shape))
    hard_noise = _jax_hard_noise(key, 0, [r.shape for r in rect]) if cfg["model"].get("hard") else None
    return dict(name=request.param, cfg=cfg, model=jm, params=params, batch=batch, key=key,
                metrics=jax.tree.map(np.asarray, metrics), grads=jax.tree.map(np.asarray, new.opt_state["g"]),
                biased=biased, rect=rect, noise=noise, hard_noise=hard_noise)


def _port(run):
    pm = port_model(run["params"], num_samples=T, dropout=0.0, **run["cfg"]["model"])
    hard = None if run["hard_noise"] is None else [torch.from_numpy(h) for h in run["hard_noise"]]
    return pm, torch.from_numpy(run["noise"]), hard


def test_inputs_clear_the_mask_margin(run):
    if run["cfg"]["model"].get("learned_hc"):
        enc = run["params"]["params"]["encoder"]
        reps = np.asarray(run["model"].tables.sizes)
        sp = lambda r: np.repeat(np.log1p(np.exp(enc[r].astype(np.float64))), reps)  # noqa: E731
        stretch = (sp("hc_beta_raw"), -sp("hc_gamma_raw"), 1.0 + sp("hc_zeta_raw"))
    else:
        stretch = (TEMPERATURE, -0.1, 1.1)
    margin = clip_margin(hc_preclip(run["biased"], run["noise"], *stretch))
    assert margin > PARITY_MARGIN, f"a pre-clip gate within {margin} of 0 or 1"
    if run["hard_noise"] is not None:
        margin = draw_margin(run["hard_noise"], run["rect"])
        assert margin > PARITY_MARGIN, f"a Bernoulli draw within {margin} of its probability"


def test_hc_train_step_loss_and_gradients_match_jax(run):
    pm, noise, hard = _port(run)
    weights = LossWeights(l0_penalty=run["cfg"]["l0"])
    total, comps, grads = make_loss_and_grads(pm, weights)(
        torch.from_numpy(run["batch"]), TEMPERATURE, 0, 0, noise, hard)
    want = run["metrics"]
    np.testing.assert_allclose(float(total), float(want["total_loss"]), rtol=LOSS_RTOL)
    for k, w in want.items():
        if k != "grad_norms":
            np.testing.assert_allclose(float(comps[k]), float(w), rtol=LOSS_RTOL, atol=1e-6, err_msg=k)
    if run["cfg"]["l0"]:
        assert float(comps["l0_loss"]) > 0
    ref = _leaves(run["grads"], pm.state_dict())
    assert grads.keys() == ref.keys()
    assert all(grads[n].shape == ref[n].shape and torch.isfinite(grads[n]).all() for n in ref)
    err = _l2(grads[n] - ref[n] for n in ref) / _l2(ref.values())
    assert err <= GRAD_REL_L2, err


def test_hc_every_gradient_leaf_matches_jax_on_a_well_conditioned_objective(run):
    jm = run["model"]
    pm, noise, hard = _port(run)
    w = np.random.default_rng(8).standard_normal((B, 1, T)).astype(np.float32)
    rng = jax.random.fold_in(run["key"], 0)
    want_val, want = jax.jit(jax.value_and_grad(_jax_surrogate(jm, jnp.asarray(w), TEMPERATURE)))(
        jax.tree.map(jnp.asarray, run["params"]), jnp.asarray(run["batch"]), rng)
    want = _leaves(want, pm.state_dict())
    val = _port_surrogate(pm, torch.from_numpy(run["batch"]), noise, torch.from_numpy(w), TEMPERATURE, hard)
    names, params = zip(*pm.named_parameters())
    got = dict(zip(names, torch.autograd.grad(val, params)))
    np.testing.assert_allclose(val.item(), float(want_val), rtol=1e-4)
    scale = max(v.abs().max().item() for v in want.values())
    assert got.keys() == want.keys()
    for n in want:
        err = (got[n] - want[n]).abs().max().item()
        assert err <= SURROGATE_RTOL * scale, (n, err, scale)
    if run["cfg"]["model"].get("learned_hc"):
        for n in ("encoder.hc_beta_raw", "encoder.hc_gamma_raw", "encoder.hc_zeta_raw"):
            assert got[n].shape == (4,) and got[n].abs().max() > 0, n


def test_hc_train_step_updates_every_leaf(run):
    """One applied step (accumulation 1) moves every parameter the loss
    reaches, the stretch leaves included, by at most its group's rate."""
    pm, noise, hard = _port(run)
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    opt = make_optimizer(accumulate_grad_batches=1)
    state = create_train_state(pm, opt)
    step = make_train_step(pm, opt, LossWeights(l0_penalty=run["cfg"]["l0"]))
    state, metrics = step(state, torch.from_numpy(run["batch"]), TEMPERATURE, 0, noise, hard)
    assert state.step == 1 and torch.isfinite(metrics["total_loss"])
    for n, p in pm.named_parameters():
        lr = 1e-3 if n.startswith("encoder.") else 1e-4
        assert (p.detach() - before[n]).abs().max() <= 1.01 * lr, n
    stretch = [n for n in before if n.startswith("encoder.hc_")]
    assert len(stretch) == (3 if run["cfg"]["model"].get("learned_hc") else 0)
    for n in stretch:
        assert not torch.equal(dict(pm.named_parameters())[n].detach(), before[n]), n


# bf16 against fp32 on the same weights and uniforms (test_torch_training.py:
# the spectral loss's relative-L2 term divides by the small reconstruction's
# energy, so bf16 rounding upstream moves the loss by several percent).
BF16_LOSS_RTOL = 0.1


def test_hc_bf16_step_is_finite_and_close_to_fp32(run, monkeypatch):
    """A bf16 step is finite, its fp32 masters stay finite, its loss is near
    JAX's fp32 loss; the learned stretch reaches the sampler rounded to
    bf16 (the JAX encoder's _hc_stretch(biased.dtype)), and the sampler
    returns bf16 gates."""
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete

    seen = []
    original = fused_hard_concrete.hard_concrete_learned_sample

    def spy(log_alpha, beta, gamma, zeta, **kw):
        seen.append((log_alpha.dtype, beta.dtype, gamma.dtype, zeta.dtype))
        return original(log_alpha, beta, gamma, zeta, **kw)

    monkeypatch.setattr(fused_hard_concrete, "hard_concrete_learned_sample", spy)
    pm, noise, hard = _port(run)
    opt = make_optimizer(accumulate_grad_batches=1)
    step = make_train_step(pm, opt, LossWeights(l0_penalty=run["cfg"]["l0"]), compute_dtype=torch.bfloat16)
    state, metrics = step(create_train_state(pm, opt), torch.from_numpy(run["batch"]), TEMPERATURE, 0, noise, hard)
    assert all(torch.isfinite(v) for v in metrics.values())
    assert all(p.dtype == torch.float32 and torch.isfinite(p).all() for p in pm.parameters())
    np.testing.assert_allclose(float(metrics["total_loss"]), float(run["metrics"]["total_loss"]),
                               rtol=BF16_LOSS_RTOL)
    if run["cfg"]["model"].get("learned_hc"):
        assert seen == [(torch.bfloat16,) * 4]
    else:
        assert seen == []
