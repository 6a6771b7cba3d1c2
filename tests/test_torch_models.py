"""PyTorch port vs the JAX package at the tiny config: encoder logits and
latent, SCCN, decoder, the full eval ``__call__`` and the train-mode
``__call__`` on injected uniforms; the Hard Concrete samplers (fixed and
learned stretch) and the straight-through hard path, in training and in
eval; the port's dropout.

One jitted JAX forward, with the intermediates captured, serves every
test; the port runs the same converted parameters on the same clips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (
    TINY,
    WAVE_SEED,
    clip_margin,
    draw_margin,
    flax_params,
    hc_preclip,
    jax_hard_noise,
    margin_mask,
    port_model,
    waveforms,
)

from topo_audio_autoencoder_torch.topology import RectifiedProbs, build_operators
from topo_audio_autoencoder_tpu.models import AudioAutoencoder as JaxAutoencoder

torch.set_num_threads(1)

# fp32 in both packages. The JAX side runs XLA's fused CPU kernels, the
# port PyTorch's; they sum in different orders, so logits differ by ~2e-6
# and waveforms by ~6e-6 at this config (measured). The tolerances leave
# a decade of room.
LOGIT_ATOL = 2e-5
FEATURE_ATOL = 5e-5
WAVE_ATOL = 1e-4
# A latent bit is compared where its biased logit is this far from 0.5,
# a hundred times the logit tolerance.
MARGIN = 2e-3


@pytest.fixture(scope="module")
def jax_model():
    return JaxAutoencoder.create(**TINY)


@pytest.fixture(scope="module")
def params(jax_model):
    return flax_params(jax_model)


@pytest.fixture(scope="module")
def setup(jax_model, params):
    jm = jax_model
    x = waveforms(WAVE_SEED, 2)
    names = {"compute_logits", "__call__"}
    fwd = jax.jit(
        lambda p, x: jm.apply(
            p, x, 1.0, None, False,
            capture_intermediates=lambda mdl, name: name in names,
        )
    )
    out, state = fwd(params, jnp.asarray(x))
    with torch.no_grad():
        pm = port_model(params)
        port_out = pm(torch.from_numpy(x))
    return jm, pm, x, out, state["intermediates"], port_out


def test_encoder_logits_and_latent_match(setup):
    jm, pm, x, out, inter, port_out = setup
    logits = np.asarray(inter["encoder"]["compute_logits"][0])
    np.testing.assert_allclose(port_out.encoder_output.logits.numpy(), logits, atol=LOGIT_ATOL)
    safe = margin_mask(logits, jm.tables.num_vertices, MARGIN)
    assert safe.mean() > 0.9, "the parity seed leaves too many near-threshold logits"
    for r, (got, want) in enumerate(zip(port_out.encoder_output.probs.ranks, out.encoder_output.probs)):
        sl = slice(jm.tables.offsets[r], jm.tables.offsets[r] + jm.tables.sizes[r])
        np.testing.assert_array_equal(got.numpy()[safe[:, sl]], np.asarray(want)[safe[:, sl]])
    # The parity latent exercises every rank.
    assert [int(p.sum()) for p in port_out.encoder_output.probs.ranks] == [10, 18, 11, 2]


def _port_inputs_from_jax_latent(pm, out):
    """Embeddings, operators and masks rebuilt by the port from the JAX
    encoder's latent: the SCCN and decoder then see the same inputs."""
    rect = RectifiedProbs(*(torch.from_numpy(np.array(p)) for p in out.encoder_output.rectified))
    masks = tuple((p > 0).to(p.dtype) for p in rect.ranks)
    ops = build_operators(rect, pm.tables, masks=masks)
    return pm.encoder.embed(rect), ops, masks


def test_embeddings_match(setup):
    jm, pm, x, out, inter, port_out = setup
    with torch.no_grad():
        emb, _, _ = _port_inputs_from_jax_latent(pm, out)
    for got, want in zip(emb, out.encoder_output.embeddings):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FEATURE_ATOL)


def test_sccn_matches_jax(setup):
    jm, pm, x, out, inter, port_out = setup
    with torch.no_grad():
        emb, ops, _ = _port_inputs_from_jax_latent(pm, out)
        feats = pm.decoder.sccn(list(emb), ops, train=False)
    want = inter["decoder"]["sccn"]["__call__"][0]
    for got, w in zip(feats, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=FEATURE_ATOL)


def test_sccn_layer_train_mode_matches_jax(setup, params):
    """A non-final layer applies its LayerNorm (flax eps 1e-6) in training."""
    from topo_audio_autoencoder_tpu.models.sccn import GradientSCCNLayer as JaxLayer

    jm, pm, x, out, inter, port_out = setup
    with torch.no_grad():
        emb, ops, _ = _port_inputs_from_jax_latent(pm, out)
        got = pm.decoder.sccn.layer_0(list(emb), ops, train=True)
    layer = JaxLayer(channels=TINY["sccn_hidden_dim"])
    p0 = {"params": params["params"]["decoder"]["sccn"]["layer_0"]}
    want = jax.jit(lambda p, f, o: layer.apply(p, f, o, True))(
        p0, list(out.encoder_output.embeddings), out.encoder_output.ops
    )
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL)


def test_decoder_matches_jax(setup):
    jm, pm, x, out, inter, port_out = setup
    with torch.no_grad():
        emb, ops, masks = _port_inputs_from_jax_latent(pm, out)
        sub = pm.decoder(emb, ops, masks, x.shape[-1] // jm.num_bands)
    want = np.asarray(inter["decoder"]["__call__"][0])
    assert sub.shape == want.shape == (2, x.shape[-1] // jm.num_bands, jm.num_bands)
    np.testing.assert_allclose(sub.numpy(), want, atol=FEATURE_ATOL)


def test_forward_waveform_and_aux_match(setup):
    jm, pm, x, out, inter, port_out = setup
    assert port_out.waveform.shape == (2, 1, x.shape[-1])
    np.testing.assert_allclose(port_out.waveform.numpy(), np.asarray(out.waveform), atol=WAVE_ATOL)
    np.testing.assert_array_equal(port_out.valid.numpy(), np.asarray(out.valid))
    assert port_out.aux.keys() == out.aux.keys()
    for key in out.aux:
        np.testing.assert_allclose(port_out.aux[key].numpy(), np.asarray(out.aux[key]), atol=1e-6)


def test_geometry_and_param_count_match(setup, params):
    jm, pm, x, out, inter, port_out = setup
    assert pm.geometry() == jm.geometry()
    assert pm.num_params() == jm.num_params(params)


def test_train_mode_is_not_ported(params):
    """train=True against JAX: the sampled relaxation (on the uniforms JAX
    draws from its key), the SCCN's LayerNorms, the decoder. Dropout is off
    in both (flax's dropout stream cannot be reproduced; see the dropout
    test). The name predates the port of the train path and of the last
    options of ``create`` (packed operators, jumping knowledge, max_rank
    truncation): ``create`` accepts each, and ``geometry()`` hands
    ``pack_capacities`` back as a list."""
    jm = JaxAutoencoder.create(**TINY, dropout=0.0)
    x = waveforms(WAVE_SEED, 2)
    rng = jax.random.PRNGKey(4)
    out = jax.jit(lambda p, x: jm.apply(p, x, 0.5, rng, True))(params, jnp.asarray(x))
    sample_rng, _ = jax.random.split(rng)
    u = np.array(jax.random.uniform(sample_rng, (2, jm.tables.total_simplices), minval=1e-6, maxval=1.0 - 1e-6))
    pm = port_model(params, dropout=0.0)
    with torch.no_grad():
        got = pm(torch.from_numpy(x), 0.5, train=True, noise=torch.from_numpy(u))
    for g, w in zip(got.encoder_output.probs.ranks, out.encoder_output.probs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(out.valid))
    np.testing.assert_allclose(got.waveform.numpy(), np.asarray(out.waveform), atol=WAVE_ATOL)
    for key in out.aux:
        np.testing.assert_allclose(got.aux[key].numpy(), np.asarray(out.aux[key]), atol=1e-5)
    # The fused and the plain sampler agree on the same uniforms.
    pm.encoder.use_fused_sampler = False
    with torch.no_grad():
        plain = pm(torch.from_numpy(x), 0.5, train=True, noise=torch.from_numpy(u))
    np.testing.assert_allclose(plain.waveform.numpy(), got.waveform.numpy(), atol=1e-6)
    for option, caps in ((dict(pack_capacities=(None, None, 8, 4)), [None, None, 8, 4]),
                         (dict(use_jumping_knowledge=True), None), (dict(max_rank=1), None)):
        built = type(pm).create(**TINY, num_samples=x.shape[-1], device="cpu", **option)
        assert built.geometry()["pack_capacities"] == caps
        again = type(pm).create(**TINY, num_samples=x.shape[-1], device="cpu",
                                pack_capacities=built.geometry()["pack_capacities"])
        assert again.geometry() == built.geometry()


def test_dropout_rate_and_scaling():
    """Inverted dropout as flax's: a fraction ``rate`` zeroed, the rest
    scaled by 1 / (1 - rate); off at rate 0 and in eval."""
    from topo_audio_autoencoder_torch.models.encoder import dropout

    x = torch.ones(200_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    zero = (y == 0).float().mean().item()
    assert abs(zero - 0.1) < 5 * (0.1 * 0.9 / x.numel()) ** 0.5
    kept = y[y != 0]
    torch.testing.assert_close(kept, torch.full_like(kept, 1 / 0.9), rtol=0, atol=0)
    assert dropout(x, 0.0, None) is x
    assert torch.equal(dropout(x, 0.1, torch.Generator().manual_seed(0)), y)
    with pytest.raises(ValueError, match="generator"):
        dropout(x, 0.1, None)


def test_train_mode_draws_dropout_and_sampler_from_the_generator(setup):
    jm, pm, x, out, inter, port_out = setup  # dropout 0.1
    xt = torch.from_numpy(x)
    with torch.no_grad():
        a = pm(xt, 1.0, train=True, generator=torch.Generator().manual_seed(3))
        b = pm(xt, 1.0, train=True, generator=torch.Generator().manual_seed(3))
        c = pm(xt, 1.0, train=True, generator=torch.Generator().manual_seed(4))
        e = pm.encoder.compute_logits(pm.pqmf(xt).transpose(-1, -2), train=False)
    assert torch.equal(a.waveform, b.waveform)
    assert not torch.equal(a.waveform, c.waveform)
    assert not torch.equal(a.encoder_output.logits, e)  # dropout was on
    assert torch.isfinite(a.waveform).all()
    with pytest.raises(ValueError, match="generator"):
        pm(xt, 1.0, train=True)


# The Hard Concrete and hard paths. Five models, each in train mode on the
# uniforms JAX draws from its key (sampler and Bernoulli), in eval, and,
# for the hard ones, in eval with a key (Bernoulli draws, as BASELINE
# config 1 encodes).
HC_COMBOS = {
    "hc": dict(sampler="hard_concrete"),
    "hc_learned": dict(sampler="hard_concrete", learned_hc=True),
    "hc_hard": dict(sampler="hard_concrete", hard=True),
    "hc_learned_hard": dict(sampler="hard_concrete", learned_hc=True, hard=True),
    "gumbel_hard": dict(hard=True),
}
HC_CASES = [(c, m) for c in HC_COMBOS for m in ("train", "eval")] + [
    (c, "eval_rng") for c, kw in HC_COMBOS.items() if kw.get("hard")
]
HC_TEMPERATURE = 0.5
HC_RNG = 7
# A gate whose pre-clip value lies within the packages' rounding difference
# of 0 is exactly 0 on one side and ~1e-8 on the other, and flips its mask
# bit; a uniform that close to its Bernoulli probability flips the draw.
# Logits differ by ~2e-6 here, probabilities by less: every pre-clip gate
# and every draw of the parity inputs must clear this margin (reported on
# failure), which the seeds above are chosen to give.
PARITY_MARGIN = 1e-4


@pytest.fixture(scope="module")
def hc_models():
    cache = {}

    def get(combo):
        if combo not in cache:
            jm = JaxAutoencoder.create(**TINY, dropout=0.0, **HC_COMBOS[combo])
            params = flax_params(jm)
            cache[combo] = (jm, params, port_model(params, dropout=0.0, **HC_COMBOS[combo]))
        return cache[combo]

    return get


def _stretch(jm, params):
    """Per-simplex (beta, gamma, zeta) of a learned model, in float64."""
    enc = params["params"]["encoder"]
    sp = lambda r: np.log1p(np.exp(enc[r].astype(np.float64)))  # noqa: E731
    reps = np.asarray(jm.tables.sizes)
    return (np.repeat(sp("hc_beta_raw"), reps), np.repeat(-sp("hc_gamma_raw"), reps),
            np.repeat(1.0 + sp("hc_zeta_raw"), reps))


@pytest.mark.parametrize("combo,mode", HC_CASES)
def test_hard_concrete_and_hard_paths_match_jax(hc_models, combo, mode):
    jm, params, pm = hc_models(combo)
    kw = HC_COMBOS[combo]
    x = waveforms(WAVE_SEED, 2)
    train = mode == "train"
    rng = None if mode == "eval" else jax.random.PRNGKey(HC_RNG)
    out, state = jax.jit(lambda p, x: jm.apply(
        p, x, HC_TEMPERATURE, rng, train, capture_intermediates=lambda m, n: n == "compute_logits",
    ))(params, jnp.asarray(x))
    logits = np.asarray(state["intermediates"]["encoder"]["compute_logits"][0])
    biased = logits.copy()
    biased[:, : jm.tables.num_vertices] += 2.0  # relu(vertex_bias)
    rect = [np.asarray(p) for p in out.encoder_output.rectified]
    u = hard_u = None
    if rng is not None:
        sample_rng, hard_rng = jax.random.split(rng)
        if train and kw.get("sampler") == "hard_concrete":
            u = np.array(jax.random.uniform(sample_rng, biased.shape, minval=1e-6, maxval=1.0 - 1e-6))
        if kw.get("hard"):
            hard_u = jax_hard_noise(hard_rng, [r.shape for r in rect])
    if kw.get("sampler") == "hard_concrete":
        beta, gamma, zeta = _stretch(jm, params) if kw.get("learned_hc") else (HC_TEMPERATURE, -0.1, 1.1)
        margin = clip_margin(hc_preclip(biased, u if train else None, beta, gamma, zeta))
        assert margin > PARITY_MARGIN, f"a pre-clip gate within {margin} of 0 or 1"
    if kw.get("hard"):
        draws = hard_u if hard_u is not None else [np.full_like(r, 0.5) for r in rect]
        margin = draw_margin(draws, rect)
        assert margin > PARITY_MARGIN, f"a Bernoulli draw within {margin} of its probability"

    with torch.no_grad():
        got = pm(torch.from_numpy(x), HC_TEMPERATURE, train=train,
                 noise=None if u is None else torch.from_numpy(u),
                 hard_noise=None if hard_u is None else [torch.from_numpy(h) for h in hard_u])
    enc, want = got.encoder_output, out.encoder_output
    np.testing.assert_allclose(enc.logits.numpy(), logits, atol=LOGIT_ATOL)
    for name in ("rectified", "probs"):
        for g, w in zip(getattr(enc, name).ranks, getattr(want, name)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL, err_msg=name)
    for g, w in zip(enc.masks, want.masks):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if kw.get("hard"):  # binary up to the straight-through sum's ulp
        for p in enc.probs.ranks:
            assert ((p - p.round()).abs() <= 1e-6).all()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(out.valid))
    np.testing.assert_allclose(enc.l0.numpy(), np.asarray(want.l0), atol=1e-6)
    np.testing.assert_allclose(got.waveform.numpy(), np.asarray(out.waveform), atol=WAVE_ATOL)
    assert pm.geometry() == jm.geometry()
    assert pm.num_params() == jm.num_params(params)


def test_hard_concrete_fused_and_plain_samplers_agree(hc_models):
    """use_fused_sampler=False (the plain samplers of ops.samplers) gives
    what the fused path gives on the same uniforms."""
    x = torch.from_numpy(waveforms(WAVE_SEED, 2))
    for combo in ("hc", "hc_learned_hard"):
        _, _, pm = hc_models(combo)
        u = torch.from_numpy(np.random.default_rng(3).uniform(1e-6, 1 - 1e-6, (2, pm.tables.total_simplices))
                             .astype(np.float32))
        hard_u = [torch.from_numpy(np.random.default_rng(4 + r).uniform(size=(2, s)).astype(np.float32))
                  for r, s in enumerate(pm.tables.sizes)]
        with torch.no_grad():
            fused = pm(x, HC_TEMPERATURE, train=True, noise=u, hard_noise=hard_u)
            pm.encoder.use_fused_sampler = False
            try:
                plain = pm(x, HC_TEMPERATURE, train=True, noise=u, hard_noise=hard_u)
            finally:
                pm.encoder.use_fused_sampler = True
        np.testing.assert_allclose(plain.waveform.numpy(), fused.waveform.numpy(), atol=1e-6)


def test_learned_hc_init_matches_fixed_stretch():
    """learned_hc at its inits (beta 2/3, gamma -0.1, zeta 1.1) samples as
    the fixed stretch at T = 2/3, and ignores the temperature argument."""
    from topo_audio_autoencoder_torch.models import AudioAutoencoder as TorchAutoencoder

    kw = dict(**TINY, num_samples=1024, device="cpu", sampler="hard_concrete", use_fused_sampler=False,
              dropout=0.0)
    fixed = TorchAutoencoder.create(**kw, seed=5)
    learned = TorchAutoencoder.create(**kw, seed=5, learned_hc=True)
    for r in ("hc_beta_raw", "hc_gamma_raw", "hc_zeta_raw"):
        assert getattr(learned.encoder, r).shape == (4,)
    x = torch.from_numpy(waveforms(60, 2))
    u = torch.from_numpy(np.random.default_rng(64).uniform(1e-6, 1 - 1e-6, (2, fixed.tables.total_simplices))
                         .astype(np.float32))
    with torch.no_grad():
        of = fixed(x, 2.0 / 3.0, train=True, noise=u)
        ol = learned(x, 123.0, train=True, noise=u)  # the temperature argument is ignored
    for a, b in zip(of.encoder_output.probs.ranks, ol.encoder_output.probs.ranks):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    np.testing.assert_allclose(of.aux["l0"].numpy(), ol.aux["l0"].numpy(), atol=1e-6)


@pytest.mark.parametrize("option,match", [
    (dict(sampler="bernoulli"), "sampler must be"),
    (dict(learned_hc=True), "learned_hc requires"),
])
def test_sampler_options_are_checked(option, match):
    from topo_audio_autoencoder_torch.models import AudioAutoencoder as TorchAutoencoder

    with pytest.raises(ValueError, match=match):
        TorchAutoencoder.create(**TINY, num_samples=1024, device="cpu", **option)


# The gathers whose backward the port writes itself, so that it adds in a
# fixed order on the card: in float64 each equals autograd's own backward of
# the plain gather (the same products, summed in another order), and the
# forward is the plain gather's, bit for bit.


def _resize_reference(x, i0, i1, w):
    return x[..., i0, :] * (1.0 - w) + x[..., i1, :] * w


@pytest.mark.parametrize("t,out", [(250, 500), (7, 3), (5, 13), (1, 4)])
def test_linear_resize_backward_equals_the_gathers(t, out):
    from topo_audio_autoencoder_torch.models.decoder import _resize_plan, linear_resize

    rng = np.random.default_rng(t * 31 + out)
    x = torch.tensor(rng.standard_normal((3, t, 6)), requires_grad=True)
    g = torch.tensor(rng.standard_normal((3, out, 6)))
    i0, i1, w, _ = _resize_plan(t, out, x.device)
    got, want = linear_resize(x, out), _resize_reference(x, i0, i1, w.to(x.dtype))
    assert torch.equal(got, want)
    torch.testing.assert_close(torch.autograd.grad(got, x, g)[0], torch.autograd.grad(want, x, g)[0],
                               rtol=1e-12, atol=1e-12)


def test_masked_linear_resize_backward_equals_the_gathers():
    from topo_audio_autoencoder_torch.models.decoder import masked_linear_resize

    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal((3, 20, 6)), requires_grad=True)
    g = torch.tensor(rng.standard_normal((3, 250, 6)))
    valid = torch.tensor([20, 7, 0])
    got = masked_linear_resize(x, valid, 250)
    vl = valid.to(torch.float32)[:, None]
    j = torch.arange(250, dtype=torch.float32)[None, :]
    src = torch.minimum(torch.clamp((j + 0.5) * vl / 250 - 0.5, min=0.0), torch.clamp(vl - 1.0, min=0.0))
    i0 = torch.floor(src).long()
    i1 = torch.minimum(i0 + 1, torch.clamp(valid[:, None] - 1, min=0))
    w = (src - i0)[..., None].to(x.dtype)
    want = (torch.gather(x, 1, i0[..., None].expand(-1, -1, 6)) * (1.0 - w)
            + torch.gather(x, 1, i1[..., None].expand(-1, -1, 6)) * w)
    assert torch.equal(got, want)
    torch.testing.assert_close(torch.autograd.grad(got, x, g)[0], torch.autograd.grad(want, x, g)[0],
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,max_rank", [(20, 3), (6, 1)])
def test_rectifier_face_gather_backward_equals_the_gather(n, max_rank):
    from topo_audio_autoencoder_torch.topology import build_tables
    from topo_audio_autoencoder_torch.topology.rectifier import _FaceGather, face_adjoints, face_indices

    tables = build_tables(n, max_rank)
    rng = np.random.default_rng(n)
    cpu = torch.device("cpu")
    for idx, adjoint, size in zip(face_indices(tables, cpu), face_adjoints(tables, cpu), tables.sizes):
        x = torch.tensor(rng.standard_normal((2, size)), requires_grad=True)
        g = torch.tensor(rng.standard_normal((2, *idx.shape)))
        got = _FaceGather.apply(x, idx, adjoint)
        assert torch.equal(got, x[..., idx])
        torch.testing.assert_close(torch.autograd.grad(got, x, g)[0], torch.autograd.grad(x[..., idx], x, g)[0],
                                   rtol=1e-12, atol=1e-12)
