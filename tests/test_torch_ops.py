"""PyTorch port vs the JAX package: PQMF, eval sampler, SCCN combine and
the masked attention's plain version (against the JAX reference and the
Pallas kernel in interpret mode) and its wrapper's CPU behaviour."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch.ops import attention as pt_attn
from topo_audio_autoencoder_torch.ops.pqmf import PQMF as TorchPQMF
from topo_audio_autoencoder_torch.ops.samplers import binary_gumbel as pt_binary_gumbel
from topo_audio_autoencoder_torch.ops.sccn_combine import (
    message_combine_reference as pt_combine,
)
from topo_audio_autoencoder_tpu.ops import attention as jax_attn
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


def test_binary_gumbel_eval_matches_jax_and_train_is_not_ported():
    logits = np.random.default_rng(5).standard_normal((3, 30)).astype(np.float32)
    logits[0, :3] = (0.5, np.nextafter(np.float32(0.5), np.float32(1)), 0.4999999)
    got = pt_binary_gumbel(torch.from_numpy(logits), None, 1.0, training=False)
    want = jax_binary_gumbel(jnp.asarray(logits), None, 1.0, training=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(NotImplementedError, match="training slice"):
        pt_binary_gumbel(torch.from_numpy(logits), torch.Generator(), 1.0, training=True)


def test_gelu_is_the_tanh_form():
    from topo_audio_autoencoder_torch.ops.sccn_combine import _gelu

    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(
        _gelu(torch.from_numpy(x)).numpy(), np.asarray(jax.nn.gelu(jnp.asarray(x), approximate=True)),
        rtol=1e-6, atol=1e-6,
    )
