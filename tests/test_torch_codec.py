"""PyTorch port vs the JAX package: the codec (encode, decode of a shared
latent, reconstruct), the wire format in both directions, and the port's
refusal to fall back to the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import TINY, WAVE_SEED, flax_params, margin_mask, port_model, waveforms

from topo_audio_autoencoder_torch import inference as pt_inf
from topo_audio_autoencoder_torch.models import AudioAutoencoder as TorchAutoencoder
from topo_audio_autoencoder_tpu import inference as jax_inf
from topo_audio_autoencoder_tpu.models import AudioAutoencoder as JaxAutoencoder

torch.set_num_threads(1)

# fp32 in both packages; XLA and PyTorch sum in different orders (see
# test_torch_models.py, where the same model is measured at ~6e-6).
WAVE_ATOL = 1e-4
MARGIN = 2e-3  # compare latent bits only this far from the threshold


@pytest.fixture(scope="module")
def codecs():
    jm = JaxAutoencoder.create(**TINY)
    params = flax_params(jm)
    x = waveforms(WAVE_SEED, 2)
    jcodec = jax_inf.Codec(jm, params)
    pcodec = pt_inf.Codec(port_model(params), device="cpu")
    return jm, params, x, jcodec, pcodec


def test_encode_matches_jax(codecs):
    jm, params, x, jcodec, pcodec = codecs
    got = pcodec.encode(x)
    want = jcodec.encode(jnp.asarray(x))
    encode = jax.jit(
        lambda p, a: jm.apply(p, a, 1.0, None, False, method=lambda m, a, t, r, tr: m.encode(a, t, r, tr))
    )
    logits = np.asarray(encode(params, jnp.asarray(x)).logits)
    safe = margin_mask(logits, jm.tables.num_vertices, MARGIN)
    assert safe.mean() > 0.9
    for r, (g, w) in enumerate(zip(got.ranks, want.ranks)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert set(np.unique(g.numpy())) <= {0.0, 1.0}
        sl = slice(jm.tables.offsets[r], jm.tables.offsets[r] + jm.tables.sizes[r])
        np.testing.assert_array_equal(g.numpy()[safe[:, sl]], np.asarray(w)[safe[:, sl]])


def test_decode_of_a_shared_latent_matches_jax(codecs):
    jm, params, x, jcodec, pcodec = codecs
    latent = jcodec.encode(jnp.asarray(x))
    want = np.asarray(jcodec.decode(latent, x.shape[-1]))
    got = pcodec.decode(pt_inf.SimplicialLatent(*(np.asarray(r) for r in latent.ranks)), x.shape[-1])
    assert got.shape == (2, 1, x.shape[-1])
    np.testing.assert_allclose(got.numpy(), want, atol=WAVE_ATOL)


def test_reconstruct_matches_jax_and_decode_of_encode(codecs):
    jm, params, x, jcodec, pcodec = codecs
    got = pcodec.reconstruct(x)
    np.testing.assert_allclose(got.numpy(), np.asarray(jcodec.reconstruct(jnp.asarray(x))), atol=WAVE_ATOL)
    # The latent is a sufficient code in the port too.
    again = pcodec.decode(pcodec.encode(x), x.shape[-1])
    np.testing.assert_allclose(again.numpy(), got.numpy(), atol=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_pack_latent_bytes_interoperate(codecs, direction):
    jm, params, x, jcodec, pcodec = codecs
    n = jm.tables.num_vertices
    if direction == "jax_to_torch":
        latent = jcodec.encode(jnp.asarray(x))
        wire = jax_inf.pack_latent(latent)
        decoded = pt_inf.unpack_latent(wire, n)
        np.testing.assert_array_equal(pt_inf.pack_latent(decoded), wire)
    else:
        latent = pcodec.encode(x)
        wire = pt_inf.pack_latent(latent)
        decoded = jax_inf.unpack_latent(wire, n)
        np.testing.assert_array_equal(jax_inf.pack_latent(decoded), wire)
    assert wire.dtype == np.uint8 and wire.shape == (2, (sum(jm.tables.sizes) + 7) // 8)
    for a, b in zip(latent.ranks, decoded.ranks):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_entry_points_refuse_to_fall_back_to_the_cpu(codecs, monkeypatch):
    jm, params, x, jcodec, pcodec = codecs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pt_inf.Codec(pcodec.model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchAutoencoder.create(**TINY, num_samples=x.shape[-1])


def test_create_is_seeded():
    a = TorchAutoencoder.create(**TINY, num_samples=1024, seed=3, device="cpu").state_dict()
    b = TorchAutoencoder.create(**TINY, num_samples=1024, seed=3, device="cpu").state_dict()
    c = TorchAutoencoder.create(**TINY, num_samples=1024, seed=4, device="cpu").state_dict()
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["encoder.mlp2.weight"], c["encoder.mlp2.weight"])
    # flax init families: zero biases, unit norm scales, the fixed scalars,
    # lecun-normal kernels (std 1/sqrt(fan_in)), normal(1.0) tables.
    assert float(a["encoder.skip_weight"]) == pytest.approx(0.1)
    assert float(a["encoder.vertex_bias"]) == 2.0
    assert float(a["decoder.attention_scale"]) == 0.5
    assert (a["encoder.mlp0.bias"] == 0).all() and (a["encoder.mlp_norm0.weight"] == 1).all()
    assert (a["decoder.tnorm0.weight"] == 1).all() and (a["decoder.sccn.layer_0.scale_same"] == 1).all()
    w = a["encoder.mlp1.weight"]  # [1024, 2048]
    assert float(w.std()) == pytest.approx(1 / np.sqrt(2048), rel=0.02)
    assert float(w.abs().max()) <= 2 / np.sqrt(2048) / 0.87962566103423978 + 1e-6
    assert float(a["encoder.embed_rank1"].std()) == pytest.approx(1.0, rel=0.2)


# Hard Concrete models: the eval latent is continuous (soft) or binary to
# an ulp (hard: the straight-through sum); pack_latent thresholds it at 0.5
# in both packages. Bytes are compared where every latent value clears the
# threshold by HC_MARGIN (a 1e-6 difference cannot flip a bit there).
HC_MARGIN = 1e-4


@pytest.mark.parametrize("options", [dict(sampler="hard_concrete"), dict(sampler="hard_concrete", hard=True),
                                     dict(sampler="hard_concrete", learned_hc=True)],
                         ids=["hc", "hc_hard", "hc_learned"])
def test_hard_concrete_latent_packs_to_jax_bytes(options):
    jm = JaxAutoencoder.create(**TINY, **options)
    params = flax_params(jm)
    x = waveforms(WAVE_SEED, 2)
    want = jax_inf.Codec(jm, params).encode(jnp.asarray(x))
    pcodec = pt_inf.Codec(port_model(params, **options), device="cpu")
    got = pcodec.encode(x)
    assert pcodec.model.geometry() == jm.geometry()
    margin = min(float(np.abs(np.asarray(w) - 0.5).min()) for w in want.ranks)
    assert margin > HC_MARGIN, f"a latent value within {margin} of the 0.5 threshold"
    for g, w in zip(got.ranks, want.ranks):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    wire = pt_inf.pack_latent(got)
    np.testing.assert_array_equal(wire, jax_inf.pack_latent(want))
    # The wire round trip is the threshold, bit for bit, and decodes (after
    # the re-rectification) to the JAX package's waveform.
    back = pt_inf.unpack_latent(wire, jm.tables.num_vertices)
    for g, b in zip(got.ranks, back.ranks):
        np.testing.assert_array_equal(b.numpy(), (g.numpy() >= 0.5).astype(np.float32))
    np.testing.assert_array_equal(pt_inf.pack_latent(back), wire)
    want_wave = np.asarray(jax_inf.Codec(jm, params).decode(jax_inf.unpack_latent(wire, jm.tables.num_vertices),
                                                            x.shape[-1]))
    np.testing.assert_allclose(pcodec.decode(back, x.shape[-1]).numpy(), want_wave, atol=WAVE_ATOL)
    if options.get("hard"):  # binary up to the straight-through sum's ulp
        for g in got.ranks:
            assert ((g - g.round()).abs() <= 1e-6).all()
