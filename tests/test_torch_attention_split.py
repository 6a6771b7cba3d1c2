"""The CUDA attention forward's split over keys, mirrored in torch on the CPU.

``attention_fwd_split_plain`` does the kernel's arithmetic (per-split max,
sum and accumulator over whole 64-key windows, merged in split order); it
is held against the plain forward and the JAX package's
``_reference_attention`` on the same numpy inputs, at the edges of the
windows and the splits. ``_num_splits`` picks the kernel's split count.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch.ops import attention as pt_attn
from topo_audio_autoencoder_tpu.ops import attention as jax_attn

# fp32: the same fp32 sums in other orders. bf16: both round one fp32
# output to bf16, at most one ulp apart (2^-6 below |o| = 2).
TOL_FP32 = 1e-6
TOL_BF16 = 2.0 ** -6
H = 2
# One compile per shape, not one per primitive.
_jax_reference = jax.jit(jax_attn._reference_attention, static_argnums=4)


def _inputs(b, q, m, c=8, seed=0, density=0.4):
    """Element 0 fully masked; element 1 a single active key, the last one;
    the rest about ``density`` active keys."""
    rng = np.random.default_rng(seed)
    query = rng.standard_normal((b, q, c)).astype(np.float32)
    keys = rng.standard_normal((b, m, c)).astype(np.float32)
    values = rng.standard_normal((b, m, c)).astype(np.float32)
    mask = (rng.uniform(size=(b, m)) < density).astype(np.float32)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, m - 1] = 1.0
    return query, keys, values, mask


def _windows(m):
    return -(-m // pt_attn.KEY_TILE)


def _check_against_references(inputs, splits):
    q, k, v, mask = inputs
    t = [torch.from_numpy(a) for a in inputs]
    want, want_lse = pt_attn.attention_fwd_plain(*t, H)
    ref = np.asarray(_jax_reference(*map(jnp.asarray, inputs), H))
    valid = mask.sum(axis=-1) > 0
    for s in splits:
        out, lse = pt_attn.attention_fwd_split_plain(*t, H, s)
        assert out.shape == want.shape and out.dtype == torch.float32
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=TOL_FP32, err_msg=f"S={s}")
        np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TOL_FP32, err_msg=f"S={s}")
        np.testing.assert_allclose(lse.numpy()[valid], want_lse.numpy()[valid], rtol=TOL_FP32,
                                   atol=TOL_FP32, err_msg=f"S={s}")
        # A fully masked element: exact zeros and L = +inf.
        assert (out[~torch.from_numpy(valid)] == 0).all()
        assert torch.isposinf(lse[~torch.from_numpy(valid)]).all()
        # A single active key: every row is that key's value.
        np.testing.assert_allclose(out[1].numpy(), np.broadcast_to(v[1, -1], out[1].shape),
                                   rtol=0, atol=TOL_FP32)


@pytest.mark.parametrize("splits", [1, 2, 3, _windows(200)], ids=lambda s: f"S{s}")
def test_split_matches_plain_and_jax(splits):
    _check_against_references(_inputs(3, 20, 200), [splits])


@pytest.mark.parametrize("q", [1, 250])
@pytest.mark.parametrize("m", [1, 63, 64, 65])
def test_split_edges(m, q):
    """Ragged and whole windows, one query row and a codec-width query;
    every split count from 1 to one window per split, and more splits than
    windows (empty key ranges)."""
    inputs = _inputs(3, q, m, seed=m + q)
    _check_against_references(inputs, sorted({1, 2, 3, _windows(m), _windows(m) + 1}))


def test_split_with_no_active_key():
    """Four windows in four splits; only the first and the last window hold
    active keys, so splits 1 and 2 contribute m = -inf, l = 0."""
    q, k, v, mask = _inputs(3, 20, 256, seed=4)
    mask[2] = 0.0
    mask[2, [3, 17, 200, 255]] = 1.0
    bounds = pt_attn.split_bounds(256, 4)
    assert bounds == [(0, 64), (64, 128), (128, 192), (192, 256)]
    assert mask[2, 64:192].sum() == 0
    _check_against_references((q, k, v, mask), [1, 2, 4])


def test_split_bf16():
    inputs = _inputs(3, 20, 200, seed=5)
    t = [torch.from_numpy(a) for a in inputs]
    t[:3] = [x.to(torch.bfloat16) for x in t[:3]]
    want, _ = pt_attn.attention_fwd_plain(*t, H)
    for s in (1, 3, 4):
        out, lse = pt_attn.attention_fwd_split_plain(*t, H, s)
        assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
        assert (out.float() - want.float()).abs().max().item() <= TOL_BF16
        assert (out[0] == 0).all() and torch.isposinf(lse[0]).all()


def test_split_bounds_cover_the_keys_in_whole_windows():
    for m in (1, 63, 64, 65, 200, 6175):
        for s in range(1, _windows(m) + 1):
            bounds = pt_attn.split_bounds(m, s)
            assert bounds[0][0] == 0 and bounds[-1][1] == m
            assert all(hi > lo for lo, hi in bounds)  # no empty split while S <= windows
            assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
            assert all(lo % pt_attn.KEY_TILE == 0 for lo, _ in bounds)


def test_num_splits_bounds_and_purity():
    for b in (1, 2, 8, 16, 300, 65535):
        for h in (1, 4, 8):
            for tq in (1, 250, 257, 4096):
                for m in (0, 1, 64, 65, 6175):
                    for sms in (1, 114, 132):
                        s = pt_attn._num_splits(b, h, tq, m, sms)
                        assert 1 <= s <= max(1, _windows(m))
                        assert b * s <= 65535  # the kernel's grid: B*S blocks in z
                        assert pt_attn._num_splits(b, h, tq, m, sms) == s
    # The train step's attention (B=16, H=4, Q=250, M=6175) and the codec's
    # (B=8) on a 132-SM H100: 576 and 544 blocks of 256 rows.
    assert pt_attn._num_splits(16, 4, 250, 6175, 132) == 9
    assert pt_attn._num_splits(8, 4, 250, 6175, 132) == 17
