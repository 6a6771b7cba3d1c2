"""The CUDA attention backward's split of dq over keys, mirrored in torch on
the CPU.

``attention_bwd_split_plain`` does the kernels' dq arithmetic (per split of
whole 64-key windows a partial sum of ds k over that split's active keys,
the partials summed in split order, then scaled by 1/sqrt(D)); it is held
against the plain backward and ``jax.vjp`` of the JAX package's
``_reference_attention`` on the same numpy inputs, at the edges of the
windows, of the splits and of the dk/dv kernel's 256-key ranges.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch.ops import attention as pt_attn
from topo_audio_autoencoder_tpu.ops import attention as jax_attn

# Each gradient within this fraction of its largest element. fp32: the same
# fp32 sums in other orders (tests/test_torch_ops.py's BWD_RTOL). bf16: both
# round one fp32 sum to bf16 once (2^-7 relative).
TOL_FP32 = 1e-5
TOL_BF16 = 2.0 ** -7
# A single active key gives ds = p (dp - delta) = 0 in exact arithmetic: dq
# and dk are then round-off, held within this fraction of their scale.
TOL_SINGLE_KEY = 1e-6
H = 2


@jax.jit
def _jax_vjp(query, keys, values, key_mask, dout):
    """dq, dk, dv of the JAX reference: one compile per shape."""
    _, vjp = jax.vjp(lambda a, b, c: jax_attn._reference_attention(a, b, c, key_mask, H), query, keys, values)
    return vjp(dout)


def _inputs(b, q, m, c=8, seed=0, density=0.4):
    """Element 0 fully masked; element 1 a single active key, the last one
    (in the last window); the rest about ``density`` active keys."""
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((b, q, c)).astype(np.float32)
    keys = rng.standard_normal((b, m, c)).astype(np.float32)
    values = rng.standard_normal((b, m, c)).astype(np.float32)
    mask = (rng.uniform(size=(b, m)) < density).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, m - 1] = 1.0
    dout = rng.standard_normal((b, q, c)).astype(np.float32)
    return query, keys, values, mask, dout


def _windows(m):
    return -(-m // pt_attn.KEY_TILE)


def _check_against_references(inputs, splits):
    q, k, v, mask, dout = inputs
    t = [torch.from_numpy(a) for a in inputs]
    out, lse = pt_attn.attention_fwd_plain(*t[:4], H)
    plain = pt_attn.attention_bwd_plain(*t[:4], out, lse, t[4], H)
    ref = [np.asarray(g) for g in _jax_vjp(*map(jnp.asarray, inputs))]
    # The scale a nonzero ds k (or ds q) would have: |dO| |v| |k| (or |q|).
    single_scale = np.abs(dout).max() * np.abs(v).max() * max(np.abs(k).max(), np.abs(q).max())
    # With at most one active key per element, dq and dk are round-off only.
    at_most_one = mask.sum(axis=-1).max() <= 1
    for s in splits:
        got = pt_attn.attention_bwd_split_plain(*t[:4], out, lse, t[4], H, s)
        for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
            assert g.dtype == torch.float32 and g.shape == p.shape, (name, s)
            if at_most_one and name != "dv":
                assert g.abs().max().item() <= TOL_SINGLE_KEY * single_scale, (name, s)
                continue
            atol = TOL_FP32 * np.abs(r).max()
            np.testing.assert_allclose(g.numpy(), p.numpy(), rtol=0, atol=atol, err_msg=f"{name} S={s}")
            np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=atol, err_msg=f"{name} S={s} vs JAX")
        dq, dk, dv = got
        # A fully masked element: exact zeros; masked keys: exact zero rows.
        assert (dq[0] == 0).all() and (dk[0] == 0).all() and (dv[0] == 0).all()
        inactive = torch.from_numpy(mask == 0)
        assert (dk[inactive] == 0).all() and (dv[inactive] == 0).all()
        # A single active key in the last window: dq is round-off only.
        dq_scale = single_scale if at_most_one else np.abs(ref[0]).max()
        assert dq[1].abs().max().item() <= TOL_SINGLE_KEY * dq_scale, s


@pytest.mark.parametrize("splits", [1, 2, 3, _windows(200)], ids=lambda s: f"S{s}")
def test_bwd_split_matches_plain_and_jax(splits):
    _check_against_references(_inputs(3, 20, 200), [splits])


@pytest.mark.parametrize("q", [1, 250])
@pytest.mark.parametrize("m", [1, 63, 64, 65, 255, 256, 257])
def test_bwd_split_edges(m, q):
    """Ragged and whole windows, the dk/dv kernel's 256-key range edges, one
    query row and a codec-width query; every split count from 1 to one
    window per split, and more splits than windows (empty key ranges)."""
    inputs = _inputs(3, q, m, seed=m + q)
    _check_against_references(inputs, sorted({1, 2, 3, _windows(m), _windows(m) + 1}))


def test_bwd_split_with_no_active_key():
    """Four windows in four splits; only the first and the last window hold
    active keys, so splits 1 and 2 contribute a zero partial."""
    q, k, v, mask, dout = _inputs(3, 20, 256, seed=4)
    mask[2] = 0.0
    mask[2, [3, 17, 200, 255]] = 1.0
    assert pt_attn.split_bounds(256, 4) == [(0, 64), (64, 128), (128, 192), (192, 256)]
    assert mask[2, 64:192].sum() == 0
    _check_against_references((q, k, v, mask, dout), [1, 2, 4])


def test_bwd_split_single_key_in_last_window():
    """Every element but the fully masked one has a single active key in the
    ragged last window (257 keys: window 4 holds key 256 alone)."""
    q, k, v, mask, dout = _inputs(3, 250, 257, seed=7)
    mask[2] = 0.0
    mask[2, 256] = 1.0
    _check_against_references((q, k, v, mask, dout), [1, 3, 5])


@pytest.mark.parametrize("splits", [1, 3, 4], ids=lambda s: f"S{s}")
def test_bwd_split_bf16(splits):
    inputs = _inputs(3, 20, 200, seed=5)
    t = [torch.from_numpy(a) for a in inputs]
    t = [x.to(torch.bfloat16) if i in (0, 1, 2, 4) else x for i, x in enumerate(t)]
    out, lse = pt_attn.attention_fwd_plain(*t[:4], H)
    want = pt_attn.attention_bwd_plain(*t[:4], out, lse, t[4], H)
    got = pt_attn.attention_bwd_split_plain(*t[:4], out, lse, t[4], H, splits)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16 and g.shape == w.shape, name
        scale = w.float().abs().max().item()
        assert (g.float() - w.float()).abs().max().item() <= TOL_BF16 * scale, name
    assert all((g[0] == 0).all() for g in got)
