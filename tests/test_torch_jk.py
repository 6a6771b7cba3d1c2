"""PyTorch port vs the JAX package: ``max_rank`` truncation and the
jumping-knowledge SCCN, at the tiny config (n=5, 4 bands, C=8, 2 layers).

- ``max_rank=1`` (vertices and edges only, BASELINE config 2's hierarchy):
  the parameter set equals the flax tree's, leaf for leaf; the forward and
  the rank-diversity entropy (which leaves the empty ranks out) match.
- ``use_jumping_knowledge``: the SCCN module alone, the model's forward,
  and a train step's every gradient leaf through the well-conditioned
  surrogate of tests/test_torch_training.py; the same step for the n=8
  packed model of tests/test_torch_packed.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import TINY, WAVE_SEED, flax_params, port_model, waveforms
from test_torch_packed import CAPS as PACKED_CAPS
from test_torch_packed import MODEL as PACKED_MODEL
from test_torch_packed import SELECT_MARGIN
from test_torch_training import TEMPERATURE, _jax_surrogate, _leaves, _port_surrogate, jax_step_noise

from topo_audio_autoencoder_torch import topology as pt
from topo_audio_autoencoder_torch.convert import state_dict_from_flax
from topo_audio_autoencoder_torch.models import AudioAutoencoder as TorchAutoencoder
from topo_audio_autoencoder_torch.models.encoder import rank_diversity_entropy
from topo_audio_autoencoder_torch.models.sccn import JumpingKnowledgeSCCN, LSTMCell
from topo_audio_autoencoder_tpu import topology as jt
from topo_audio_autoencoder_tpu.models import AudioAutoencoder as JaxAutoencoder
from topo_audio_autoencoder_tpu.models.encoder import rank_diversity_entropy as jax_entropy
from topo_audio_autoencoder_tpu.models.sccn import JumpingKnowledgeSCCN as JaxJK

torch.set_num_threads(1)

# As tests/test_torch_models.py: fp32 in both packages, other summation
# orders (features ~5e-6, waveforms ~6e-6 measured there).
FEATURE_ATOL = 5e-5
WAVE_ATOL = 1e-4
AUX_ATOL = 1e-5
TRAIN_RNG = 4


@pytest.fixture(scope="module")
def max_rank1():
    """The max_rank=1 JAX model, its parameters, the port model on the
    converted tree, and JAX's eval and train forwards on the parity clips
    (train on its own key; dropout off in both)."""
    x = waveforms(WAVE_SEED, 2)
    jm = JaxAutoencoder.create(**TINY, dropout=0.0, max_rank=1)
    params = flax_params(jm)
    rng = jax.random.PRNGKey(TRAIN_RNG)
    eval_out, train_out = jax.jit(lambda p, x: (jm.apply(p, x, 0.5, None, False), jm.apply(p, x, 0.5, rng, True)))(
        params, jnp.asarray(x))
    sample_rng, _ = jax.random.split(rng)
    u = np.array(jax.random.uniform(sample_rng, (2, jm.tables.total_simplices), minval=1e-6, maxval=1.0 - 1e-6))
    return dict(jm=jm, params=params, pm=port_model(params, dropout=0.0, max_rank=1), x=x, u=u,
                eval=eval_out, train=train_out)


def test_max_rank_1_parameters_are_the_flax_trees(max_rank1):
    """The converted tree fills every port parameter and nothing else (the
    conversion raises otherwise); the final layer holds what the flax layer
    creates over ranks 0-1 and nothing for ranks 2-3."""
    m = max_rank1
    pm, jm, params = m["pm"], m["jm"], m["params"]
    assert pm.tables.sizes == (5, 10, 0, 0)
    assert pm.num_params() == jm.num_params(params)
    flax_names = {".".join(path) for path, _ in _flatten(params["params"])}
    port_names = {n.removesuffix(".weight") for n, _ in pm.named_parameters()}
    assert len(flax_names) == len(port_names) == len(list(pm.parameters()))
    final = {n.split(".", 3)[3] for n, _ in pm.named_parameters() if n.startswith("decoder.sccn.layer_1.")}
    assert final == {"same_rank_0", "same_rank_1", "attn_w1_0", "attn_b1_0", "attn_w2_0", "attn_w1_1",
                     "attn_b1_1", "attn_w2_1", "high_to_low_0", "low_to_high_1", "scale_same",
                     "scale_low_to_high", "scale_high_to_low"}
    layer0 = {n.split(".", 3)[3] for n, _ in pm.named_parameters() if n.startswith("decoder.sccn.layer_0.")}
    assert layer0 == final | {"norm_0.weight", "norm_0.bias", "norm_1.weight", "norm_1.bias"}
    assert pm.encoder.embed_rank2.shape == pm.encoder.embed_rank3.shape == (0, TINY["sccn_hidden_dim"])
    assert all(hasattr(pm.encoder, f"embed_norm{r}") for r in range(4))


def _flatten(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, (*path, k))
        else:
            yield (*path, "weight" if k in ("kernel", "scale") else k), v


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_max_rank_1_forward_matches_jax(max_rank1, mode):
    """The waveform, the aux terms (the entropy over the ranks present) and
    the latent; train mode on JAX's uniforms."""
    m = max_rank1
    with torch.no_grad():
        if mode == "eval":
            got = m["pm"](torch.from_numpy(m["x"]), 0.5)
        else:
            got = m["pm"](torch.from_numpy(m["x"]), 0.5, train=True, noise=torch.from_numpy(m["u"]))
    want = m[mode]
    np.testing.assert_allclose(got.waveform.numpy(), np.asarray(want.waveform), atol=WAVE_ATOL)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    for key in want.aux:
        np.testing.assert_allclose(got.aux[key].numpy(), np.asarray(want.aux[key]), atol=AUX_ATOL, err_msg=key)
    for g, w in zip(got.encoder_output.rectified.ranks, want.encoder_output.rectified):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL)
    assert float(np.abs(np.asarray(want.aux["binary_entropy"])).min()) > 0


def test_entropy_leaves_out_the_empty_ranks():
    rng = np.random.default_rng(2)
    ranks = [rng.uniform(size=(3, s)).astype(np.float32) for s in (5, 10, 0, 0)]
    got = rank_diversity_entropy(pt.RectifiedProbs(*(torch.from_numpy(r) for r in ranks)))
    want = jax_entropy(jt.RectifiedProbs(*(jnp.asarray(r) for r in ranks)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    two = np.stack([r.mean(-1) for r in ranks[:2]], -1)
    dist = two / two.sum(-1, keepdims=True)
    np.testing.assert_allclose(got.numpy(), 0.1 * (dist * np.log(dist)).sum(-1), rtol=1e-5)


@pytest.fixture(scope="module")
def jk_model():
    """A JK model and its parameters, at the surrogate step's clip length."""
    jm = JaxAutoencoder.create(**TINY, dropout=0.0, use_jumping_knowledge=True)
    return jm, flax_params(jm, num_samples=T_STEP)


@pytest.fixture(scope="module")
def jk_sccn(jk_model):
    """The JK module's inputs (one rectified complex, random features, the
    JK model's SCCN parameters) and JAX's outputs in eval and in training
    (the layers' norms), from one compiled function."""
    c, n = TINY["sccn_hidden_dim"], TINY["num_vertices"]
    params = jk_model[1]["params"]["decoder"]["sccn"]
    tables = pt.build_tables(n)
    rng = np.random.default_rng(5)
    p = rng.uniform(size=(2, tables.total_simplices)).astype(np.float32)
    p[p < 0.3] = 0.0
    feats = [rng.standard_normal((2, s, c)).astype(np.float32) for s in tables.sizes]
    jrect = jt.enforce_constraints_flat(jnp.asarray(p), jt.build_tables(n))
    jk = JaxJK(channels=c, n_layers=TINY["n_sccn_layers"])
    want = jax.jit(lambda prm, f, o: {t: jk.apply({"params": prm}, f, o, t) for t in (False, True)})(
        params, [jnp.asarray(f) for f in feats], jt.build_operators(jrect, jt.build_tables(n)))
    return params, tables, p, feats, want


@pytest.mark.parametrize("train", [False, True])
def test_jumping_knowledge_sccn_matches_jax(jk_sccn, train):
    """The JK module alone: its two layers, then the two LSTM cells over
    the layer axis, per simplex."""
    params, tables, p, feats, want = jk_sccn
    port = JumpingKnowledgeSCCN(TINY["sccn_hidden_dim"], TINY["n_sccn_layers"], tables.sizes)
    port.load_state_dict(state_dict_from_flax(params, port.state_dict()))
    rect = pt.enforce_constraints_flat(torch.from_numpy(p), tables)
    with torch.no_grad():
        got = port([torch.from_numpy(f) for f in feats], pt.build_operators(rect, tables), train)
    for g, w in zip(got, want[train]):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=FEATURE_ATOL)


def test_lstm_cell_init_is_flaxs():
    """Lecun-normal input kernels, orthogonal hidden kernels, zero biases;
    the same seed gives the same cell."""
    c = 16
    cells = [LSTMCell(c) for _ in range(2)]
    for cell in cells:
        cell.reset_parameters(torch.Generator().manual_seed(3))
    for g in "ifgo":
        w = getattr(cells[0], f"h{g}").weight
        torch.testing.assert_close(w @ w.T, torch.eye(c), atol=1e-5, rtol=0)
        assert bool((getattr(cells[0], f"h{g}").bias == 0).all())
        assert getattr(cells[0], f"i{g}").bias is None
        std = getattr(cells[0], f"i{g}").weight.std().item()
        assert abs(std - c ** -0.5) < 0.2 * c ** -0.5
        assert torch.equal(getattr(cells[0], f"i{g}").weight, getattr(cells[1], f"i{g}").weight)


# Every gradient leaf of the surrogate, relative to the largest element
# (tests/test_torch_training.py's bound).
SURROGATE_RTOL = 1e-4
T_STEP = 2048
RUN_SEED = 3
# The surrogate step's models: the JK model at the tiny config, and the
# packed model of tests/test_torch_packed.py (its packed gathers, one-hot
# scatter products, embedding gathers and gathered probabilities, backward).
STEP_MODELS = {
    "jk": (TINY, dict(use_jumping_knowledge=True)),
    "packed": (PACKED_MODEL, dict(pack_capacities=PACKED_CAPS)),
}


@pytest.mark.parametrize("case", sorted(STEP_MODELS))
def test_train_step_forward_and_gradients_match_jax_through_the_surrogate(jk_model, case):
    """One train step's forward (the reconstruction, train mode on JAX's
    uniforms) and every gradient leaf of the surrogate objective, for the
    JK model and the packed one. The packed step keeps each packed rank's
    K rows of highest select key: the K-th and (K+1)-th must clear
    SELECT_MARGIN first, else a row could change sides between the
    packages."""
    config, options = STEP_MODELS[case]
    if case == "jk":
        jm, params = jk_model
    else:
        jm = JaxAutoencoder.create(**config, dropout=0.0, **options)
        params = flax_params(jm, num_samples=T_STEP)
    batch = waveforms(5, 6, T_STEP).reshape(2, 3, 1, T_STEP)
    w = np.random.default_rng(7).standard_normal((2, 1, T_STEP)).astype(np.float32)
    key = jax.random.PRNGKey(RUN_SEED)
    pm = TorchAutoencoder.create(**config, num_samples=T_STEP, device="cpu", dropout=0.0, **options)
    pm.load_state_dict(state_dict_from_flax(params, pm.state_dict()))
    noise = torch.from_numpy(np.array(jax_step_noise(key, 0, (2, jm.tables.total_simplices))))
    if case == "packed":
        with torch.no_grad():
            logits = pm.encoder.compute_logits(pm.pqmf(torch.from_numpy(batch).reshape(6, 1, T_STEP))
                                               .transpose(-1, -2), True)
            rect = pm.encoder.generate_complex(logits.reshape(2, 3, -1)[:, 0], TEMPERATURE, True,
                                               noise=noise).rectified.ranks
        for r in (2, 3):
            top = np.sort(rect[r].numpy() + (rect[r].numpy() > 0), axis=-1)[:, ::-1]
            margin = float((top[:, PACKED_CAPS[r] - 1] - top[:, PACKED_CAPS[r]]).min())
            assert margin > SELECT_MARGIN, f"rank {r}: the K-th and (K+1)-th keys are {margin} apart"
    (want_val, want_recon), want = jax.jit(jax.value_and_grad(
        _jax_surrogate(jm, jnp.asarray(w), with_recon=True), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(batch), jax.random.fold_in(key, 0))
    want = _leaves(want, pm.state_dict())
    val, recon = _port_surrogate(pm, torch.from_numpy(batch), noise, torch.from_numpy(w), with_recon=True)
    np.testing.assert_allclose(recon.detach().numpy(), np.asarray(want_recon), atol=WAVE_ATOL)
    np.testing.assert_allclose(val.item(), float(want_val), rtol=1e-4)
    names, leaves = zip(*pm.named_parameters())
    got = dict(zip(names, torch.autograd.grad(val, leaves)))
    assert got.keys() == want.keys()
    if case == "jk":
        assert {n for n in got if ".OptimizedLSTMCell_" in n} == {
            f"decoder.sccn.OptimizedLSTMCell_{i}.{k}.{leaf}" for i in (0, 1) for g in "ifgo"
            for k, leaf in ((f"i{g}", "weight"), (f"h{g}", "weight"), (f"h{g}", "bias"))}
    scale = max(v.abs().max().item() for v in want.values())
    for n in want:
        err = (got[n] - want[n]).abs().max().item()
        assert err <= SURROGATE_RTOL * scale, (n, err, scale)
