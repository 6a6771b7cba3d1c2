"""PyTorch port vs the JAX package: PQMF, the samplers (eval and train,
plain and fused, with the fused sampler's closed-form gradient and its
Philox generator), SCCN combine, and the masked attention's plain forward
and backward (against the JAX reference, its VJP and the Pallas kernels in
interpret mode) and their wrappers' CPU behaviour."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch.ops import attention as pt_attn
from topo_audio_autoencoder_torch.ops import fused_samplers as pt_fused
from topo_audio_autoencoder_torch.ops import samplers as pt_samplers
from topo_audio_autoencoder_torch.ops.pqmf import PQMF as TorchPQMF
from topo_audio_autoencoder_torch.ops.samplers import binary_gumbel as pt_binary_gumbel
from topo_audio_autoencoder_torch.ops.sccn_combine import (
    message_combine_reference as pt_combine,
)
from topo_audio_autoencoder_tpu.ops import attention as jax_attn
from topo_audio_autoencoder_tpu.ops import pallas_kernels as jax_pk
from topo_audio_autoencoder_tpu.ops import samplers as jax_samplers
from topo_audio_autoencoder_tpu.ops.pqmf import PQMF as JaxPQMF
from topo_audio_autoencoder_tpu.ops.samplers import binary_gumbel as jax_binary_gumbel
from topo_audio_autoencoder_tpu.ops.sccn_combine import (
    message_combine_reference as jax_combine,
)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def pqmfs():
    return TorchPQMF(n_band=4), JaxPQMF.create(n_band=4)


def test_pqmf_filters_match(pqmfs):
    tp, jp = pqmfs
    assert tp.taps == jp.taps
    # Same numpy/scipy design in both packages, cast to fp32 once.
    np.testing.assert_array_equal(tp.filters[:, 0, :].numpy(), jp.filters)
    assert tp.recon_error == pytest.approx(jp.recon_error, rel=1e-12)


def test_pqmf_analysis_and_synthesis_match(pqmfs):
    tp, jp = pqmfs
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 1, 1024)).astype(np.float32)
    bands = tp(torch.from_numpy(x))
    assert bands.shape == (2, 4, 256)
    # fp32 convs with ~100 taps; XLA and oneDNN sum in different orders.
    np.testing.assert_allclose(bands.numpy(), np.asarray(jp.forward(jnp.asarray(x))), atol=2e-5)
    z = rng.standard_normal((2, 4, 256)).astype(np.float32)
    y = tp.inverse(torch.from_numpy(z))
    assert y.shape == (2, 1, 1024)
    np.testing.assert_allclose(y.numpy(), np.asarray(jp.inverse(jnp.asarray(z))), atol=5e-5)
    # Near-perfect reconstruction away from the edges.
    rec = tp.inverse(tp(torch.from_numpy(x))).numpy()
    n = tp.taps
    err = np.linalg.norm(rec[..., 2 * n:-2 * n] - x[..., 2 * n:-2 * n]) / np.linalg.norm(x[..., 2 * n:-2 * n])
    assert err < 1e-2


def _attn_inputs(b=3, q=20, m=200, c=8, seed=0):
    """M=200 is not a multiple of 128; element 0 is fully masked, element 1
    has a single active key, element 2 about 40% active keys."""
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((b, q, c)).astype(np.float32)
    keys = rng.standard_normal((b, m, c)).astype(np.float32)
    values = rng.standard_normal((b, m, c)).astype(np.float32)
    mask = (rng.uniform(size=(b, m)) < 0.4).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, 137] = 1.0
    return query, keys, values, mask


def test_reference_attention_matches_jax():
    q, k, v, mask = _attn_inputs()
    got = pt_attn.reference_attention(*map(torch.from_numpy, (q, k, v, mask)), 2)
    want = jax_attn._reference_attention(*map(jnp.asarray, (q, k, v, mask)), 2)
    # Same fp32 einsum/softmax; only the summation order differs.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert (got[0] == 0).all()
    # A single active key: the output is that key's value in every row.
    np.testing.assert_allclose(got[1].numpy(), np.broadcast_to(v[1, 137], got[1].shape), atol=1e-6)


def test_plain_attention_matches_pallas_kernel_interpret():
    """Output against the TPU kernel's own (interpret-mode) output, and the
    port's log-sum-exp against the weights P that kernel writes."""
    h = 2
    q, k, v, mask = _attn_inputs()
    b, tq, c = q.shape
    tm = k.shape[1]
    d = c // h
    qp, mp = jax_attn._round_up(tq, 128), jax_attn._round_up(tm, 128)
    split = lambda x: jax_attn._split_heads(jnp.asarray(x), h)  # noqa: E731
    qh = jnp.pad(split(q), ((0, 0), (0, qp - tq), (0, 0)))
    kth = jnp.pad(jnp.swapaxes(split(k), 1, 2), ((0, 0), (0, 0), (0, mp - tm)))
    vth = jnp.pad(jnp.swapaxes(split(v), 1, 2), ((0, 0), (0, 0), (0, mp - tm)))
    maskp = jnp.pad(jnp.asarray(mask), ((0, 0), (0, mp - tm)))[:, None, :]
    out_k, p_k = jax_attn._attn_fwd_call(qh, kth, vth, maskp, interpret=True)
    out_k = np.asarray(jax_attn._merge_heads(out_k[:, :tq], b))
    p_k = np.asarray(p_k).reshape(b, h, qp, mp)[:, :, :tq, :tm]

    out, lse = pt_attn.attention_fwd_plain(*map(torch.from_numpy, (q, k, v, mask)), h)
    np.testing.assert_allclose(out.numpy(), out_k, rtol=1e-5, atol=1e-6)
    assert lse.shape == (b, h, tq)
    assert torch.isinf(lse[0]).all() and (lse[0] > 0).all()
    # P = exp(s - L) on active keys, 0 elsewhere: what a backward recomputes.
    s = np.einsum("bqhd,bmhd->bhqm", q.reshape(b, tq, h, d), k.reshape(b, tm, h, d)) / np.sqrt(d)
    p = np.exp(s - lse.numpy()[..., None]) * (mask[:, None, None, :] > 0)
    np.testing.assert_allclose(p, p_k, atol=1e-6)


def test_attention_wrapper_on_cpu_takes_the_plain_version():
    q, k, v, mask = map(torch.from_numpy, _attn_inputs())
    before = pt_attn.attention_fwd.launches
    out, lse = pt_attn.attention_fwd(q, k, v, mask, 2)
    want_out, want_lse = pt_attn.attention_fwd_plain(q, k, v, mask, 2)
    torch.testing.assert_close(out, want_out, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
    torch.testing.assert_close(pt_attn.fused_masked_attention(q, k, v, mask, 2), want_out, rtol=0, atol=0)
    assert pt_attn.attention_fwd.launches == before  # no kernel on the CPU


def test_attention_wrapper_rejects_bad_inputs():
    q, k, v, mask = map(torch.from_numpy, _attn_inputs())
    with pytest.raises(ValueError, match="cpu or cuda"):
        pt_attn.attention_fwd(*(t.to("meta") for t in (q, k, v, mask)), 2)
    with pytest.raises(ValueError, match="one dtype"):
        pt_attn.attention_fwd(q, k.to(torch.float64), v, mask, 2)
    with pytest.raises(ValueError, match="divisible"):
        pt_attn.attention_fwd(q, k, v, mask, 3)
    with pytest.raises(ValueError, match="key_mask"):
        pt_attn.attention_fwd(q, k, v, mask[:, :-1], 2)


def test_plain_attention_is_differentiable_on_cpu():
    q, k, v, mask = (torch.from_numpy(a) for a in _attn_inputs())
    q.requires_grad_(True)
    pt_attn.fused_masked_attention(q, k, v, mask, 2).sum().backward()
    assert torch.isfinite(q.grad).all()
    assert (q.grad[0] == 0).all()  # fully masked element: no gradient


def test_message_combine_matches_jax():
    rng = np.random.default_rng(4)
    c = 8
    cars = tuple(rng.standard_normal((2, 11, c)).astype(np.float32) for _ in range(3))
    x = rng.standard_normal((2, 11, c)).astype(np.float32)
    v = (rng.standard_normal((3, c, c)) / np.sqrt(c)).astype(np.float32)
    w1 = (rng.standard_normal((c, c)) / np.sqrt(c)).astype(np.float32)
    b1 = (0.1 * rng.standard_normal(c)).astype(np.float32)
    w2 = (rng.standard_normal((c, 1)) / np.sqrt(c)).astype(np.float32)
    got = pt_combine(tuple(map(torch.from_numpy, cars)), *map(torch.from_numpy, (x, v, w1, b1, w2)))
    want = jax_combine(tuple(map(jnp.asarray, cars)), *map(jnp.asarray, (x, v, w1, b1, w2)))
    # fp32 matmuls + tanh gelu in both; summation order differs.
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def _jax_uniforms(key, shape):
    """The uniforms JAX's binary_gumbel draws from ``key`` (float32)."""
    return np.array(jax.random.uniform(key, shape, jnp.float32, minval=1e-6, maxval=1.0 - 1e-6))


# Train-mode relaxation on the same uniforms: fp32 log/log1p/sigmoid in
# both packages, s in [0, 1].
SAMPLER_ATOL = 2e-6


def test_binary_gumbel_eval_matches_jax_and_train_is_not_ported():
    """Eval threshold and train relaxation (on JAX's own uniforms) against
    JAX. The name predates the port of the train branch."""
    logits = np.random.default_rng(5).standard_normal((3, 30)).astype(np.float32)
    logits[0, :3] = (0.5, np.nextafter(np.float32(0.5), np.float32(1)), 0.4999999)
    got = pt_binary_gumbel(torch.from_numpy(logits), None, 1.0, training=False)
    want = jax_binary_gumbel(jnp.asarray(logits), None, 1.0, training=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    key = jax.random.PRNGKey(3)
    u = torch.from_numpy(_jax_uniforms(key, logits.shape))
    for temp in (0.3, 1.0, 5.0):
        want = np.asarray(jax_binary_gumbel(jnp.asarray(logits), key, temp, training=True))
        got = pt_binary_gumbel(torch.from_numpy(logits), None, temp, training=True, noise=u)
        np.testing.assert_allclose(got.numpy(), want, atol=SAMPLER_ATOL)
        fused = pt_fused.binary_gumbel_fused(torch.from_numpy(logits), None, temp, noise=u)
        np.testing.assert_allclose(fused.numpy(), want, atol=SAMPLER_ATOL)
    with pytest.raises(ValueError, match="generator or noise"):
        pt_binary_gumbel(torch.from_numpy(logits), None, 1.0, training=True)


def test_binary_gumbel_keeps_the_logits_dtype():
    """A float temperature must not promote a bf16 relaxation to fp32."""
    logits = torch.zeros(4, 7, dtype=torch.bfloat16)
    u = torch.full((4, 7), 0.3)
    assert pt_binary_gumbel(logits, None, torch.tensor(0.7), noise=u).dtype == torch.bfloat16
    assert pt_fused.binary_gumbel_fused(logits, None, 0.7, noise=u).dtype == torch.bfloat16


def test_fused_sampler_gradient_matches_jax():
    """The closed-form backward (ds/dl = 2 s (1 - s) / T) against jax.grad
    of binary_gumbel_fused_diff on the same uniforms (tests/test_ops.py's
    construction)."""
    key = jax.random.PRNGKey(0)
    x = np.linspace(-2.0, 2.0, 64, dtype=np.float32)
    want = np.asarray(jax.grad(
        lambda l: (jax_pk.binary_gumbel_fused_diff(l, key, 0.7, True) ** 2).sum()
    )(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    u = torch.from_numpy(_jax_uniforms(key, x.shape))
    (pt_fused.binary_gumbel_fused_diff(xt, None, 0.7, noise=u) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, atol=1e-6)
    # ...which is autograd of the plain relaxation.
    xp = torch.from_numpy(x).requires_grad_(True)
    (pt_binary_gumbel(xp, None, 0.7, noise=u) ** 2).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), xp.grad.numpy(), atol=1e-6)
    # Eval mode is a threshold with no gradient.
    ev = pt_fused.binary_gumbel_fused_diff(torch.from_numpy(x), None, 0.7, training=False)
    np.testing.assert_array_equal(ev.numpy(), (x > 0.5).astype(np.float32))


def test_philox_matches_known_answers():
    """Philox4x32-10 known-answer vectors (Salmon et al., Random123 kat_vectors):
    counter 0 / key 0, and all-ones counter and key."""
    def words(seed, ctr):
        g = ctr[0] | (ctr[1] << 32)
        u = pt_fused.philox_uniform(4 * (g + 1), seed, ctr[2] | (ctr[3] << 32))[4 * g:]
        return [int(x * 2**24) for x in u.tolist()]

    def top24(ws):
        return [w >> 8 for w in ws]

    assert words(0, (0, 0, 0, 0)) == top24([0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8])
    # The all-ones counter needs g = 2^64 - 1: check the block function via
    # the mixing helpers on that counter directly.
    m = 0xFFFFFFFF
    c = [torch.tensor([m]) for _ in range(4)]
    k0 = k1 = m
    for r in range(10):
        if r:
            k0, k1 = (k0 + pt_fused._PHILOX_W[0]) & m, (k1 + pt_fused._PHILOX_W[1]) & m
        hi0, lo0 = pt_fused._mulhilo(pt_fused._PHILOX_M[0], c[0])
        hi1, lo1 = pt_fused._mulhilo(pt_fused._PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    assert [int(x) for x in c] == [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]


def test_philox_uniform_statistics():
    """Over 1M draws: mean 0.5 and half below 0.5 within 5 standard errors,
    all inside [1e-6, 1 - 1e-6] (the TPU kernel's sign-extension skew put
    every draw below 0.5)."""
    u = pt_fused.philox_uniform(1 << 20, seed=2024)
    n = u.numel()
    assert abs(u.mean().item() - 0.5) < 5 * (1 / 12) ** 0.5 / n ** 0.5
    assert abs((u < 0.5).float().mean().item() - 0.5) < 5 * 0.5 / n ** 0.5
    assert u.min().item() >= np.float32(1e-6) and u.max().item() <= np.float32(1 - 1e-6)
    # The relaxation at l = 0.5, T = 1 is sigmoid(logistic): mean 0.5.
    s = pt_fused.binary_gumbel_sample(torch.full((n,), 0.5), 1.0, seed=2024)
    assert abs(s.mean().item() - 0.5) < 0.005
    # Low temperature saturates towards the thresholded value.
    s = pt_fused.binary_gumbel_sample(torch.full((1000,), 3.0), 0.01, seed=1)
    assert s.mean().item() > 0.95


def test_fused_sampler_wrapper_on_cpu():
    logits = torch.from_numpy(np.random.default_rng(2).standard_normal((4, 37)).astype(np.float32))
    before = pt_fused.binary_gumbel_sample.launches
    s, u = pt_fused.binary_gumbel_sample(logits, 0.7, seed=9, offset=2, return_noise=True)
    assert pt_fused.binary_gumbel_sample.launches == before  # no kernel on the CPU
    torch.testing.assert_close(u.reshape(-1), pt_fused.philox_uniform(148, 9, 2), rtol=0, atol=0)
    torch.testing.assert_close(s, pt_fused.binary_gumbel_plain(logits, u, 0.7), rtol=0, atol=0)
    assert torch.equal(pt_fused.binary_gumbel_sample(logits, 0.7, seed=9, offset=2), s)
    assert not torch.equal(pt_fused.binary_gumbel_sample(logits, 0.7, seed=10, offset=2), s)
    # A generator gives the seed: the same generator state, the same sample.
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    assert torch.equal(pt_fused.binary_gumbel_fused(logits, g1, 0.7), pt_fused.binary_gumbel_fused(logits, g2, 0.7))
    with pytest.raises(ValueError, match="positive"):
        pt_fused.binary_gumbel_sample(logits, 0.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pt_fused.binary_gumbel_sample(logits.to("meta"), 1.0)


def test_temperature_schedule_and_straight_through_match_jax():
    for epoch in (0, 1, 13, 1000):
        assert float(pt_samplers.temperature_schedule(epoch)) == float(jax_samplers.temperature_schedule(epoch))
    x = torch.tensor([0.3, -0.2], requires_grad=True)
    soft = torch.sigmoid(x)
    y = pt_samplers.straight_through((soft > 0.5).to(x.dtype), soft)
    y.sum().backward()
    assert float(y.detach().sum()) == 1.0
    np.testing.assert_allclose(x.grad.numpy(), (soft * (1 - soft)).detach().numpy(), rtol=1e-6)


def _attn_bwd_inputs():
    q, k, v, mask = _attn_inputs()
    dout = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    return q, k, v, mask, dout


# dq, dk, dv in fp32, sums over up to M=200 keys in another order:
# relative to each gradient's largest element.
BWD_RTOL = 1e-5


def test_attention_backward_matches_jax_vjp():
    h = 2
    q, k, v, mask, dout = _attn_bwd_inputs()
    _, vjp = jax.vjp(
        lambda a, b, c: jax_attn._reference_attention(a, b, c, jnp.asarray(mask), h),
        *map(jnp.asarray, (q, k, v)),
    )
    want = [np.asarray(w) for w in vjp(jnp.asarray(dout))]
    tq, tk, tv, tm, td = map(torch.from_numpy, (q, k, v, mask, dout))
    out, lse = pt_attn.attention_fwd_plain(tq, tk, tv, tm, h)
    got = pt_attn.attention_bwd_plain(tq, tk, tv, tm, out, lse, td, h)
    leaves = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    pt_attn.fused_masked_attention(*leaves, tm, h).backward(td)
    for g, a, w in zip(got, leaves, want):
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=BWD_RTOL * scale)
        np.testing.assert_allclose(a.grad.numpy(), w, rtol=0, atol=BWD_RTOL * scale)
    dq, dk, dv = got
    assert (dq[0] == 0).all() and (dk[0] == 0).all() and (dv[0] == 0).all()  # fully masked
    assert (dk[mask == 0] == 0).all() and (dv[mask == 0] == 0).all()  # masked keys
    # A single key: p = 1 and ds = dp - delta, two sums of the same products
    # in other orders, so dq is zero up to their rounding.
    assert dq[1].abs().max().item() <= 1e-6 * np.abs(want[0]).max()
    np.testing.assert_allclose(dv[1, 137].numpy(), dout[1].sum(axis=0), rtol=1e-5)


def test_attention_backward_matches_pallas_kernels_interpret():
    """The TPU backward kernel, fed the TPU forward kernel's weights P (both
    in interpret mode), against the port's backward from L."""
    h = 2
    q, k, v, mask, dout = _attn_bwd_inputs()
    b, tq, c = q.shape
    tm = k.shape[1]
    qp, mp = jax_attn._round_up(tq, 128), jax_attn._round_up(tm, 128)
    split = lambda x: jax_attn._split_heads(jnp.asarray(x), h)  # noqa: E731

    def to_t(x, length, pad_to):  # [B, T, C] -> [BH, D, pad_to]
        return jnp.pad(jnp.swapaxes(split(x), 1, 2), ((0, 0), (0, 0), (0, pad_to - length)))

    qh = jnp.pad(split(q), ((0, 0), (0, qp - tq), (0, 0)))
    maskp = jnp.pad(jnp.asarray(mask), ((0, 0), (0, mp - tm)))[:, None, :]
    _, p = jax_attn._attn_fwd_call(qh, to_t(k, tm, mp), to_t(v, tm, mp), maskp, interpret=True)
    dqt, dkt, dvt = jax_attn._attn_bwd_call(
        p, to_t(dout, tq, qp), to_t(q, tq, qp), to_t(k, tm, mp), to_t(v, tm, mp), interpret=True
    )
    merge = lambda x, n: np.asarray(jax_attn._merge_heads(jnp.swapaxes(x, 1, 2)[:, :n], b))  # noqa: E731
    want = (merge(dqt, tq), merge(dkt, tm), merge(dvt, tm))
    tq_, tk, tv, tmask, td = map(torch.from_numpy, (q, k, v, mask, dout))
    out, lse = pt_attn.attention_fwd_plain(tq_, tk, tv, tmask, h)
    got = pt_attn.attention_bwd_plain(tq_, tk, tv, tmask, out, lse, td, h)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=BWD_RTOL * np.abs(w).max())


def test_attention_backward_wrapper_on_cpu():
    q, k, v, mask, dout = map(torch.from_numpy, _attn_bwd_inputs())
    out, lse = pt_attn.attention_fwd(q, k, v, mask, 2)
    before = pt_attn.attention_bwd.launches
    got = pt_attn.attention_bwd(q, k, v, mask, out, lse, dout, 2)
    assert pt_attn.attention_bwd.launches == before  # no kernel on the CPU
    want = pt_attn.attention_bwd_plain(q, k, v, mask, out, lse, dout, 2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pt_attn.attention_bwd(*(t.to("meta") for t in (q, k, v, mask, out, lse, dout)), 2)


def test_gelu_is_the_tanh_form():
    from topo_audio_autoencoder_torch.ops.sccn_combine import _gelu

    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(
        _gelu(torch.from_numpy(x)).numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)),
        rtol=1e-6, atol=1e-6,
    )


# The Hard Concrete gate (fixed and per-simplex stretch). z in [0, 1]; fp32
# log/log1p/sigmoid in both packages on the same uniforms.
HC_ATOL = 1e-6
HC_GAMMA, HC_ZETA = -0.1, 1.1


def _hc_inputs(shape=(3, 40), seed=6):
    """Log-alpha, a JAX key and its uniforms, and per-simplex stretch rows
    around the fixed one; every pre-clip gate (train and eval) at least
    1e-4 from 0 and 1, so rounding cannot move a gate across the clip."""
    from _torch_parity import clip_margin, hc_preclip

    rng = np.random.default_rng(seed)
    a = rng.normal(0.5, 2.0, shape).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    u = _jax_uniforms(key, shape)
    cols = shape[-1]
    beta = rng.uniform(0.4, 1.0, cols).astype(np.float32)
    gamma = (-rng.uniform(0.05, 0.2, cols)).astype(np.float32)
    zeta = (1.0 + rng.uniform(0.05, 0.2, cols)).astype(np.float32)
    for b, g, z in ((0.7, HC_GAMMA, HC_ZETA), (beta, gamma, zeta)):
        for uu in (u, None):
            assert clip_margin(hc_preclip(a, uu, b, g, z)) > 1e-4
    return a, key, u, (beta, gamma, zeta)


@pytest.mark.parametrize("stretch", ["fixed", "per_simplex"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_hard_concrete_matches_jax(stretch, training):
    a, key, u, (beta, gamma, zeta) = _hc_inputs()
    if stretch == "fixed":
        temp, jp, pp = 0.7, jax_samplers.HardConcreteParams(), pt_samplers.HardConcreteParams()
        jt = pt_t = temp
    else:
        jt, jp = jnp.asarray(beta), jax_samplers.HardConcreteParams(jnp.asarray(gamma), jnp.asarray(zeta))
        pt_t, pp = torch.from_numpy(beta), pt_samplers.HardConcreteParams(torch.from_numpy(gamma),
                                                                           torch.from_numpy(zeta))
    want = np.asarray(jax_samplers.hard_concrete(jnp.asarray(a), key, jt, jp, training))
    got = pt_samplers.hard_concrete(torch.from_numpy(a), None, pt_t, pp, training,
                                    noise=torch.from_numpy(u) if training else None)
    np.testing.assert_allclose(got.numpy(), want, atol=HC_ATOL)
    assert (got == 0).any() and (got == 1).any()  # both clips occur
    want_l0 = np.asarray(jax_samplers.hard_concrete_l0_penalty(jnp.asarray(a), jt, jp))
    got_l0 = pt_samplers.hard_concrete_l0_penalty(torch.from_numpy(a), pt_t, pp)
    np.testing.assert_allclose(got_l0.numpy(), want_l0, atol=HC_ATOL)
    if training:
        with pytest.raises(ValueError, match="generator or noise"):
            pt_samplers.hard_concrete(torch.from_numpy(a), None, pt_t, pp, True)


def test_hard_concrete_keeps_the_log_alpha_dtype():
    a = torch.zeros(4, 7, dtype=torch.bfloat16)
    u = torch.full((4, 7), 0.3)
    assert pt_samplers.hard_concrete(a, None, torch.tensor(0.7), noise=u).dtype == torch.bfloat16
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as pt_hc

    assert pt_hc.hard_concrete_sample(a, 0.7, noise=u).dtype == torch.bfloat16
    rows = [torch.full((7,), v) for v in (0.7, -0.1, 1.1)]
    assert pt_hc.hard_concrete_learned_sample(a, *rows, noise=u).dtype == torch.bfloat16


# The closed-form backward against jax.vjp of the JAX custom VJPs: the same
# fp32 formulas on the same z, summed over the batch in another order.
HC_GRAD_RTOL = 1e-5


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_hard_concrete_fused_gradient_matches_jax(training):
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as pt_hc

    a, key, u, _ = _hc_inputs()
    ct = np.random.default_rng(9).standard_normal(a.shape).astype(np.float32)
    z_want, vjp = jax.vjp(lambda x: jax_pk.hard_concrete_fused_diff(x, key, 0.7, training), jnp.asarray(a))
    (want,) = vjp(jnp.asarray(ct))
    at = torch.from_numpy(a).requires_grad_(True)
    z = pt_hc.hard_concrete_fused_diff(at, None, 0.7, training, noise=torch.from_numpy(u))
    z.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_want), atol=HC_ATOL)
    np.testing.assert_allclose(at.grad.numpy(), np.asarray(want), rtol=HC_GRAD_RTOL, atol=1e-7)
    assert (at.grad[(z == 0) | (z == 1)] == 0).all()  # clipped gates take none


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
def test_hard_concrete_fused_learned_gradients_match_jax(training):
    """d log-alpha and the [S] stretch cotangents (eval: d beta is zero)."""
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as pt_hc

    a, key, u, rows = _hc_inputs()
    ct = np.random.default_rng(10).standard_normal(a.shape).astype(np.float32)
    z_want, vjp = jax.vjp(
        lambda x, b, g, z: jax_pk.hard_concrete_fused_learned_diff(x, key, b, g, z, training),
        jnp.asarray(a), *map(jnp.asarray, rows))
    want = [np.asarray(w) for w in vjp(jnp.asarray(ct))]
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (a, *rows)]
    z = pt_hc.hard_concrete_fused_learned_diff(leaves[0], None, *leaves[1:], training, noise=torch.from_numpy(u))
    z.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(z_want), atol=HC_ATOL)
    for name, leaf, w in zip(("log_alpha", "beta", "gamma", "zeta"), leaves, want):
        assert leaf.grad.shape == w.shape, name
        np.testing.assert_allclose(leaf.grad.numpy(), w, rtol=HC_GRAD_RTOL, atol=1e-6, err_msg=name)
    if not training:
        assert (leaves[1].grad == 0).all()


def test_hard_concrete_wrappers_on_cpu():
    """On the CPU the wrappers run the plain versions, bit for bit, on the
    Philox stream of (seed, offset); no kernel is launched."""
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as pt_hc

    a = torch.from_numpy(np.random.default_rng(2).normal(0.5, 2.0, (4, 37)).astype(np.float32))
    rows = [torch.from_numpy(r) for r in _hc_inputs((4, 37))[3]]
    before = (pt_hc.hard_concrete_sample.launches, pt_hc.hard_concrete_learned_sample.launches)
    u_seed = pt_fused.philox_uniform(a.numel(), 9, 2).reshape(a.shape)
    z, u = pt_hc.hard_concrete_sample(a, 0.7, seed=9, offset=2, return_noise=True)
    assert torch.equal(u, u_seed)
    assert torch.equal(z, pt_hc.hard_concrete_plain(a, u_seed, 0.7))
    zl, ul = pt_hc.hard_concrete_learned_sample(a, *rows, seed=9, offset=2, return_noise=True)
    assert torch.equal(ul, u_seed)
    assert torch.equal(zl, pt_hc.hard_concrete_learned_plain(a, u_seed, *rows))
    assert (pt_hc.hard_concrete_sample.launches, pt_hc.hard_concrete_learned_sample.launches) == before
    # The plain version is the sampler of ops.samplers on those uniforms.
    np.testing.assert_allclose(z.numpy(), pt_samplers.hard_concrete(a, None, 0.7, noise=u_seed).numpy(), atol=HC_ATOL)
    # Rows equal to the fixed stretch give the fixed gates bit for bit.
    fixed_rows = [torch.full((37,), v) for v in (0.7, HC_GAMMA, HC_ZETA)]
    assert torch.equal(pt_hc.hard_concrete_learned_sample(a, *fixed_rows, seed=9, offset=2), z)
    assert not torch.equal(pt_hc.hard_concrete_sample(a, 0.7, seed=10, offset=2), z)
    g1, g2 = torch.Generator().manual_seed(4), torch.Generator().manual_seed(4)
    assert torch.equal(pt_hc.hard_concrete_fused_diff(a, g1, 0.7), pt_hc.hard_concrete_fused_diff(a, g2, 0.7))
    with pytest.raises(ValueError, match="positive"):
        pt_hc.hard_concrete_sample(a, 0.0)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pt_hc.hard_concrete_sample(a.to("meta"), 1.0)
    with pytest.raises(ValueError, match="row"):
        pt_hc.hard_concrete_learned_sample(a, rows[0][:5], *rows[1:])
    with pytest.raises(ValueError, match="generator or noise"):
        pt_hc.hard_concrete_fused_diff(a, None, 0.7)


def test_bernoulli_ste_matches_jax():
    """u < p on the uniforms jax.random.bernoulli draws from its key, with
    the gradient routed to the logits."""
    rng = np.random.default_rng(12)
    p = rng.uniform(size=(3, 50)).astype(np.float32)
    logits = rng.standard_normal((3, 50)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    want = np.asarray(jax_samplers.bernoulli_ste(jnp.asarray(p), jnp.asarray(logits), key))
    u = np.array(jax.random.uniform(key, p.shape, jnp.float32))
    assert np.abs(u - p).min() > 1e-6
    lt = torch.from_numpy(logits).requires_grad_(True)
    got = pt_samplers.bernoulli_ste(torch.from_numpy(p), lt, torch.from_numpy(u))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-6)
    got.sum().backward()
    assert (lt.grad == 1).all()
