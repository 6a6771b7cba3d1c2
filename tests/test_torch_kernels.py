"""The hand-written CUDA kernels against their plain torch versions, on the
card. Without a CUDA card every test here skips (the CPU has no kernel to
run: the wrappers take the plain version for CPU tensors, which the other
test_torch_* files hold against the JAX package).

Run on the card with ``python -m pytest --noconftest tests/test_torch_kernels.py -q``.
"""

import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch.ops import attention, fused_samplers

torch.set_num_threads(1)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# fp32: both sides compute in fp32 and differ only in summation order.
# bf16: both round the fp32 output to bf16 once; one bf16 ulp at |o| <= 4.
TOL = {torch.float32: 1e-5, torch.bfloat16: 2 ** -6}
# (B, Q, M, C, H). Beside the first two: ragged and whole 64-key windows and
# one query row (the split over keys cuts at window edges), the backward's
# 256-key dk/dv ranges at their edges, head dims 2, 4, 8 and 32 at the
# train step's Q and M, the n=32 packed model's train step (496 + 512 + 256
# keys) and BASELINE config 2's forward (max_rank=1: 190 keys).
SHAPES = [
    (3, 20, 200, 8, 2), (4, 250, 1000, 64, 4),
    (3, 1, 1, 8, 2), (3, 250, 63, 64, 4), (3, 250, 64, 64, 4), (3, 250, 65, 64, 4),
    (3, 250, 255, 64, 4), (3, 250, 256, 64, 4), (3, 250, 257, 64, 4),
    (3, 250, 6175, 8, 4), (3, 250, 6175, 16, 4), (3, 250, 6175, 32, 4), (3, 250, 6175, 128, 4),
    (16, 250, 1264, 64, 4), (8, 250, 190, 64, 4),
]
SHAPE_IDS = ["small", "d16", "m1q1", "m63", "m64", "m65", "m255", "m256", "m257", "d2", "d4", "d8", "d32",
             "packed1264", "rank1_190"]
# The backward on every shape but M=1: there each element has at most one
# key, so dq is 0 in exact arithmetic and its relative error compares
# round-off with round-off.
BWD_SHAPES = [(s, i) for s, i in zip(SHAPES, SHAPE_IDS) if s[2] > 1]
# The train step's attention: B=16, all 6,175 keys active (S = 9 on an H100).
TRAIN_SHAPE = (16, 250, 6175, 64, 4)


def _attn_inputs(cuda, dtype, shape, seed=0):
    """About 40% active keys; element 0 fully masked, element 1 a single key."""
    b, q, m, c, h = shape
    rng = np.random.default_rng(seed)
    query, keys, values = (
        torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(cuda, dtype)
        for s in ((b, q, c), (b, m, c), (b, m, c))
    )
    mask = torch.from_numpy((rng.uniform(size=(b, m)) < 0.4).astype(np.float32)).to(cuda)
    mask[0] = 0.0
    mask[1] = 0.0
    mask[1, m // 3] = 1.0
    dout = torch.from_numpy(rng.standard_normal((b, q, c)).astype(np.float32)).to(cuda, dtype)
    return query, keys, values, mask, dout


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_attention_kernel_matches_plain(cuda, dtype, shape):
    h = shape[-1]
    query, keys, values, mask, _ = _attn_inputs(cuda, dtype, shape)
    before = attention.attention_fwd.launches
    out, lse = attention.attention_fwd(query, keys, values, mask, h)
    torch.cuda.synchronize()
    assert attention.attention_fwd.launches == before + 1
    want, want_lse = attention.attention_fwd_plain(query, keys, values, mask, h)
    assert out.dtype == dtype and out.shape == query.shape
    assert (out[0] == 0).all() and torch.isinf(lse[0]).all()
    err = (out.float() - want.float()).abs().max().item()
    assert err <= TOL[dtype], err
    torch.testing.assert_close(lse[1:], want_lse[1:], rtol=1e-5, atol=1e-5)


# Gradients: fp32 sums of up to M terms in another order, relative to the
# gradient's scale (1e-4 of its largest element). bf16: the kernel and the
# plain version round the same fp32 sums to bf16 once; 2^-7 relative.
GRAD_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [s for s, _ in BWD_SHAPES], ids=[i for _, i in BWD_SHAPES])
def test_attention_backward_kernel_matches_plain(cuda, dtype, shape):
    h = shape[-1]
    query, keys, values, mask, dout = _attn_inputs(cuda, dtype, shape)
    out, lse = attention.attention_fwd(query, keys, values, mask, h)
    before = attention.attention_bwd.launches
    got = attention.attention_bwd(query, keys, values, mask, out, lse, dout, h)
    torch.cuda.synchronize()
    assert attention.attention_bwd.launches == before + 1
    want = attention.attention_bwd_plain(query, keys, values, mask, out, lse, dout, h)
    inactive = mask == 0
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == dtype and g.shape == w.shape, name
        scale = w.float().abs().max().item()
        err = (g.float() - w.float()).abs().max().item()
        assert err <= GRAD_RTOL[dtype] * scale, (name, err, scale)
    dq, dk, dv = got
    assert (dq[0] == 0).all()  # fully masked element
    assert (dk[inactive] == 0).all() and (dv[inactive] == 0).all()  # masked keys: exact zeros
    assert (dq[1] == 0).all()  # a single key: ds = p (dp - dp) = 0


def test_attention_kernel_splits_without_active_keys(cuda):
    """At the train step's Q and M: element 2 has active keys only in the
    first and the last window, so every split between them has none;
    element 1 a single key in the ragged last window."""
    b, q, m, c, h = 3, 250, 6175, 64, 4
    query, keys, values, mask, _ = _attn_inputs(cuda, torch.float32, (b, q, m, c, h))
    mask[1] = 0.0
    mask[1, m - 1] = 1.0
    mask[2] = 0.0
    mask[2, [5, 63, m - 2]] = 1.0
    splits, _ = attention.fwd_plan(query, keys, h)
    assert splits > 2
    out, lse = attention.attention_fwd(query, keys, values, mask, h)
    torch.cuda.synchronize()
    want, want_lse = attention.attention_fwd_plain(query, keys, values, mask, h)
    assert (out.float() - want.float()).abs().max().item() <= TOL[torch.float32]
    assert (out[0] == 0).all() and torch.isposinf(lse[0]).all()
    torch.testing.assert_close(lse[1:], want_lse[1:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_attention_forward_is_deterministic(cuda, dtype):
    """The split's partials merge in split order, without atomics: two calls
    on the same inputs give the same bits."""
    query, keys, values, mask, _ = _attn_inputs(cuda, dtype, TRAIN_SHAPE)
    mask[2:] = 1.0
    out, lse = attention.attention_fwd(query, keys, values, mask, TRAIN_SHAPE[-1])
    again, again_lse = attention.attention_fwd(query, keys, values, mask, TRAIN_SHAPE[-1])
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(lse, again_lse)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_attention_backward_is_deterministic(cuda, dtype):
    """dq's split partials merge in split order and every dk/dv row has one
    owner, without atomics: two calls on the same inputs give the same bits."""
    h = TRAIN_SHAPE[-1]
    query, keys, values, mask, dout = _attn_inputs(cuda, dtype, TRAIN_SHAPE)
    mask[2:] = 1.0
    assert attention.bwd_plan(query, keys, h)[0] > 1
    out, lse = attention.attention_fwd(query, keys, values, mask, h)
    got = attention.attention_bwd(query, keys, values, mask, out, lse, dout, h)
    again = attention.attention_bwd(query, keys, values, mask, out, lse, dout, h)
    torch.cuda.synchronize()
    assert all(torch.equal(g, a) for g, a in zip(got, again))


@pytest.mark.parametrize("shape", [(3, 250, 300, 64, 4), (3, 250, 300, 128, 4)], ids=["d16", "d32"])
def test_attention_backward_odd_active_keys_in_a_range(cuda, shape):
    """Element 2 holds an odd number of active keys in each dk/dv range (5 in
    the first 256 keys, 3 in the ragged rest), so at D = 16 one thread's
    second slot is empty; every masked key of the range gets zero rows."""
    h = shape[-1]
    query, keys, values, mask, dout = _attn_inputs(cuda, torch.float32, shape)
    mask[2] = 0.0
    mask[2, [0, 31, 32, 130, 255, 256, 270, 299]] = 1.0
    out, lse = attention.attention_fwd(query, keys, values, mask, h)
    got = attention.attention_bwd(query, keys, values, mask, out, lse, dout, h)
    torch.cuda.synchronize()
    want = attention.attention_bwd_plain(query, keys, values, mask, out, lse, dout, h)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert torch.isfinite(g).all(), name
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        assert err <= GRAD_RTOL[torch.float32] * scale, (name, err, scale)
    inactive = mask == 0
    assert (got[1][inactive] == 0).all() and (got[2][inactive] == 0).all()


def test_attention_backward_on_split_forward(cuda):
    """The backward kernel fed the split forward's O and L, at the train
    step's shape with every key active, against the plain backward fed the
    plain forward's."""
    h = TRAIN_SHAPE[-1]
    query, keys, values, mask, dout = _attn_inputs(cuda, torch.float32, TRAIN_SHAPE)
    mask[2:] = 1.0
    assert attention.fwd_plan(query, keys, h)[0] > 1
    out, lse = attention.attention_fwd(query, keys, values, mask, h)
    got = attention.attention_bwd(query, keys, values, mask, out, lse, dout, h)
    torch.cuda.synchronize()
    plain_out, plain_lse = attention.attention_fwd_plain(query, keys, values, mask, h)
    want = attention.attention_bwd_plain(query, keys, values, mask, plain_out, plain_lse, dout, h)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale = w.abs().max().item()
        err = (g - w).abs().max().item()
        assert err <= GRAD_RTOL[torch.float32] * scale, (name, err, scale)


def test_attention_autograd_goes_through_both_kernels(cuda):
    shape = (4, 250, 1000, 64, 4)
    query, keys, values, mask, dout = _attn_inputs(cuda, torch.float32, shape)
    leaves = [t.clone().requires_grad_(True) for t in (query, keys, values)]
    f0, b0 = attention.attention_fwd.launches, attention.attention_bwd.launches
    out = attention.fused_masked_attention(*leaves, mask, shape[-1])
    out.backward(dout)
    torch.cuda.synchronize()
    assert attention.attention_fwd.launches == f0 + 1
    assert attention.attention_bwd.launches == b0 + 1
    _, lse = attention.attention_fwd_plain(query, keys, values, mask, shape[-1])
    plain_out = attention.attention_fwd_plain(query, keys, values, mask, shape[-1])[0]
    want = attention.attention_bwd_plain(query, keys, values, mask, plain_out, lse, dout, shape[-1])
    for leaf, w in zip(leaves, want):
        err = (leaf.grad - w).abs().max().item()
        assert err <= GRAD_RTOL[torch.float32] * w.abs().max().item(), err


# s in [0, 1]: fp32 differs from the plain version by the rounding of log,
# log1p and exp; bf16 output rounds once (2^-8 is one ulp just below 1).
SAMPLER_TOL = {torch.float32: 2e-6, torch.bfloat16: 2 ** -8}
TRAIN_LOGITS = (16, 6195)  # the flagship train step: 16 anchors x 6,195 simplices


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_binary_gumbel_kernel_matches_plain(cuda, dtype):
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.normal(0.5, 2.0, TRAIN_LOGITS).astype(np.float32)).to(cuda, dtype)
    before = fused_samplers.binary_gumbel_sample.launches
    s, u = fused_samplers.binary_gumbel_sample(logits, 0.7, seed=12345, offset=3, return_noise=True)
    torch.cuda.synchronize()
    assert fused_samplers.binary_gumbel_sample.launches == before + 1
    assert s.dtype == dtype and s.shape == logits.shape and u.dtype == torch.float32
    # The kernel's generator is the plain Philox stream, bit for bit.
    want_u = fused_samplers.philox_uniform(logits.numel(), 12345, 3, cuda).reshape(logits.shape)
    assert torch.equal(u, want_u)
    want = fused_samplers.binary_gumbel_plain(logits, u, 0.7)
    assert (s.float() - want.float()).abs().max().item() <= SAMPLER_TOL[dtype]
    # Injected uniforms take the kernel's other entry point.
    s2 = fused_samplers.binary_gumbel_sample(logits, 0.7, noise=u)
    assert (s2.float() - want.float()).abs().max().item() <= SAMPLER_TOL[dtype]
    # Same (seed, offset) reproduces; another seed or offset differs.
    again = fused_samplers.binary_gumbel_sample(logits, 0.7, seed=12345, offset=3)
    assert torch.equal(again, s)
    assert not torch.equal(fused_samplers.binary_gumbel_sample(logits, 0.7, seed=12346, offset=3), s)
    assert not torch.equal(fused_samplers.binary_gumbel_sample(logits, 0.7, seed=12345, offset=4), s)


def test_binary_gumbel_kernel_uniforms_are_uniform(cuda):
    """Over 4M draws: mean 0.5 and half below 0.5 within 5 standard errors
    (the TPU kernel once shipped uniforms skewed into (0, 0.5))."""
    logits = torch.zeros(4_000_000, device=cuda)
    _, u = fused_samplers.binary_gumbel_sample(logits, 1.0, seed=99, return_noise=True)
    n = u.numel()
    assert abs(u.mean().item() - 0.5) < 5 * (1 / 12) ** 0.5 / n ** 0.5
    assert abs((u < 0.5).float().mean().item() - 0.5) < 5 * 0.5 / n ** 0.5
    assert u.min().item() >= np.float32(1e-6) and u.max().item() <= np.float32(1 - 1e-6)


def test_binary_gumbel_kernel_gradient(cuda):
    logits = torch.linspace(-2.0, 2.0, 6195, device=cuda).repeat(16, 1).requires_grad_(True)
    gen = torch.Generator().manual_seed(5)
    before = fused_samplers.binary_gumbel_sample.launches, fused_samplers.binary_gumbel_bwd.launches
    s = fused_samplers.binary_gumbel_fused_diff(logits, gen, 0.7)
    (s ** 2).sum().backward()
    # One forward and one backward kernel, each launched once.
    assert (fused_samplers.binary_gumbel_sample.launches, fused_samplers.binary_gumbel_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    sd = s.detach()
    torch.testing.assert_close(logits.grad, 2 * sd * 2 * sd * (1 - sd) / 0.7)


# Hard Concrete (rows 4 and 5): z in [0, 1]; the kernel and the plain
# version round the same fp32 operations (fp32: log/log1p/exp rounding,
# scaled by the 1.2 stretch); bf16 output one ulp below 1 (2^-8).
HC_TOL = {torch.float32: 2e-6, torch.bfloat16: 2 ** -8}
HC_LOGITS = (32, 6195)  # the Hard Concrete train step: 32 anchors x 6,195 simplices


def _hc_rows(cuda, cols, seed=3):
    """Per-simplex stretch rows around the fixed one (beta 2/3, gamma -0.1,
    zeta 1.1), as a learned model's would drift."""
    rng = np.random.default_rng(seed)
    beta = rng.uniform(0.4, 1.0, cols)
    gamma = -rng.uniform(0.05, 0.2, cols)
    zeta = 1.0 + rng.uniform(0.05, 0.2, cols)
    return [torch.from_numpy(r.astype(np.float32)).to(cuda) for r in (beta, gamma, zeta)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("learned", [False, True], ids=["fixed", "learned"])
def test_hard_concrete_kernel_matches_plain(cuda, dtype, learned):
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc

    rng = np.random.default_rng(2)
    log_alpha = torch.from_numpy(rng.normal(0.5, 2.0, HC_LOGITS).astype(np.float32)).to(cuda, dtype)
    rows = _hc_rows(cuda, HC_LOGITS[1])
    if learned:
        sample, plain, counter = (
            lambda **kw: hc.hard_concrete_learned_sample(log_alpha, *rows, **kw),
            lambda u: hc.hard_concrete_learned_plain(log_alpha, u, *rows),
            hc.hard_concrete_learned_sample,
        )
    else:
        sample, plain, counter = (
            lambda **kw: hc.hard_concrete_sample(log_alpha, 2.0 / 3.0, **kw),
            lambda u: hc.hard_concrete_plain(log_alpha, u, 2.0 / 3.0),
            hc.hard_concrete_sample,
        )
    before = counter.launches
    z, u = sample(seed=777, offset=5, return_noise=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    assert z.dtype == dtype and z.shape == log_alpha.shape and u.dtype == torch.float32
    # The kernel's uniforms are the plain Philox stream, bit for bit.
    assert torch.equal(u, fused_samplers.philox_uniform(log_alpha.numel(), 777, 5, cuda).reshape(z.shape))
    want = plain(u)
    assert (z.float() - want.float()).abs().max().item() <= HC_TOL[dtype]
    # Clipped gates are exactly 0 or 1, and both occur.
    assert ((z >= 0) & (z <= 1)).all()
    assert (z == 0).any() and (z == 1).any()
    # The injected-uniforms entry point, and reproducibility from (seed, offset).
    assert (sample(noise=u).float() - want.float()).abs().max().item() <= HC_TOL[dtype]
    assert torch.equal(sample(seed=777, offset=5), z)
    assert not torch.equal(sample(seed=778, offset=5), z)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_hard_concrete_learned_kernel_with_fixed_rows_equals_fixed_kernel(cuda, dtype):
    """Rows filled with (T, gamma, zeta) give row 4's gates bit for bit."""
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc

    log_alpha = torch.linspace(-6.0, 6.0, 4 * 6195, device=cuda).reshape(4, 6195).to(dtype)
    rows = [torch.full((6195,), v, device=cuda) for v in (2.0 / 3.0, -0.1, 1.1)]
    fixed = hc.hard_concrete_sample(log_alpha, 2.0 / 3.0, seed=9)
    learned = hc.hard_concrete_learned_sample(log_alpha, *rows, seed=9)
    assert torch.equal(fixed, learned)


def test_hard_concrete_gate_statistics(cuda):
    """Over 4M draws at log-alpha 0, T 2/3: the fractions of gates exactly 0
    and exactly 1 are each sigmoid(T log(1/11)) = 0.1682 within 5 standard
    errors, and P(z > 0) is the expected-L0 term."""
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc
    from topo_audio_autoencoder_torch.ops.samplers import hard_concrete_l0_penalty

    n = 1 << 22
    z = hc.hard_concrete_sample(torch.zeros(n, device=cuda), 2.0 / 3.0, seed=2024)
    p = 1.0 / (1.0 + np.exp(-(2.0 / 3.0) * np.log(1.0 / 11.0)))
    tol = 5 * (p * (1 - p) / n) ** 0.5
    assert abs((z == 0).float().mean().item() - p) <= tol
    assert abs((z == 1).float().mean().item() - p) <= tol
    l0 = hard_concrete_l0_penalty(torch.zeros(1), 2.0 / 3.0).item()
    assert abs((z > 0).float().mean().item() - l0) <= tol


def test_hard_concrete_kernel_gradients(cuda):
    """The autograd Functions launch the kernels once each and give the
    closed-form gradients."""
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc

    a = torch.linspace(-3.0, 3.0, 6195, device=cuda).repeat(16, 1).requires_grad_(True)
    gen = torch.Generator().manual_seed(5)
    before = hc.hard_concrete_sample.launches, hc.hard_concrete_bwd.launches
    z = hc.hard_concrete_fused_diff(a, gen, 0.7)
    z.sum().backward()
    assert (hc.hard_concrete_sample.launches, hc.hard_concrete_bwd.launches) == (before[0] + 1, before[1] + 1)
    zd = z.detach()
    s = ((zd + 0.1) / 1.2).clamp(1e-6, 1 - 1e-6)
    want = ((zd > 0) & (zd < 1)).float() * s * (1 - s) * 1.2 / 0.7
    torch.testing.assert_close(a.grad, want, rtol=1e-5, atol=1e-7)
    rows = [r.requires_grad_(True) for r in _hc_rows(cuda, 6195)]
    a.grad = None
    before = hc.hard_concrete_learned_sample.launches, hc.hard_concrete_learned_bwd.launches
    hc.hard_concrete_fused_learned_diff(a, gen, *rows).sum().backward()
    assert (hc.hard_concrete_learned_sample.launches, hc.hard_concrete_learned_bwd.launches) == (
        before[0] + 1, before[1] + 1)
    assert all(r.grad is not None and r.grad.shape == (6195,) and torch.isfinite(r.grad).all() for r in rows)
    assert torch.isfinite(a.grad).all()


@pytest.mark.parametrize("sampler", ["gumbel", "fixed", "learned"])
@pytest.mark.parametrize("shape", [(1,), (3,), (5, 37), (4097,), (16, 6195)],
                         ids=["1", "3", "5x37", "4097", "16x6195"])
def test_sampler_kernel_uniforms_at_ragged_lengths(cuda, sampler, shape):
    """Word j of Philox group g goes to element 4g + j, also where the
    length is not a multiple of four. The Gumbel kernel's thread t owns
    element t and word t & 3 of group t / 4; the Hard Concrete kernels'
    thread t owns elements 2t and 2t + 1, words (2t & 3) and (2t & 3) + 1
    of group 2t / 4, with an odd tail masked."""
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc

    x = torch.linspace(-3.0, 3.0, int(np.prod(shape)), device=cuda).reshape(shape)
    if sampler == "gumbel":
        _, u = fused_samplers.binary_gumbel_sample(x, 0.7, seed=41, offset=6, return_noise=True)
    elif sampler == "fixed":
        _, u = hc.hard_concrete_sample(x, 0.7, seed=41, offset=6, return_noise=True)
    else:
        _, u = hc.hard_concrete_learned_sample(x, *_hc_rows(cuda, shape[-1]), seed=41, offset=6, return_noise=True)
    assert torch.equal(u, fused_samplers.philox_uniform(x.numel(), 41, 6, cuda).reshape(shape))


def _sample_from(sampler, x, rows, first, **kw):
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc

    if sampler == "gumbel":
        return fused_samplers.binary_gumbel_sample(x, 0.7, first=first, return_noise=True, **kw)
    if sampler == "fixed":
        return hc.hard_concrete_sample(x, 0.7, first=first, return_noise=True, **kw)
    return hc.hard_concrete_learned_sample(x, *rows, first=first, return_noise=True, **kw)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("sampler", ["gumbel", "fixed", "learned"])
@pytest.mark.parametrize("rank,world", [(1, 2), (3, 4), (0, 2)], ids=["r1of2", "r3of4", "r0of2"])
def test_sampler_kernel_from_first_draws_the_rows_of_the_global_draw(cuda, dtype, sampler, rank, world):
    """A data-parallel rank's draw, ``first`` = its first row times the row
    length, equals its rows of the whole batch's draw bit for bit (the
    kernel is elementwise), and the plain Philox stream from ``first``."""
    s = TRAIN_LOGITS[1]
    rows = _hc_rows(cuda, s)
    x = torch.from_numpy(np.random.default_rng(4).normal(0.5, 2.0, (4 * world, s)).astype(np.float32)).to(cuda, dtype)
    whole, u_whole = _sample_from(sampler, x, rows, 0, seed=43, offset=2)
    mine = x[4 * rank : 4 * (rank + 1)].contiguous()
    first = 4 * rank * s
    got, u = _sample_from(sampler, mine, rows, first, seed=43, offset=2)
    assert torch.equal(u, u_whole[4 * rank : 4 * (rank + 1)])
    assert torch.equal(got, whole[4 * rank : 4 * (rank + 1)])
    assert torch.equal(u, fused_samplers.philox_uniform(mine.numel(), 43, 2, cuda, first).reshape(mine.shape))


@pytest.mark.parametrize("sampler", ["gumbel", "fixed", "learned"])
@pytest.mark.parametrize("first", [1, 2, 3, 6195, 2**33 + 7])
def test_sampler_kernel_uniforms_from_odd_starts(cuda, sampler, first):
    """Any start: an odd ``first`` puts every other Hard Concrete thread's
    pair across two Philox groups."""
    shape = (3, 37)
    x = torch.linspace(-3.0, 3.0, 111, device=cuda).reshape(shape)
    _, u = _sample_from(sampler, x, _hc_rows(cuda, shape[-1]), first, seed=41, offset=6)
    assert torch.equal(u, fused_samplers.philox_uniform(111, 41, 6, cuda, first).reshape(shape))


# The backward kernels against their plain versions (the same operations in
# the same order; on the card the plain version divides by a Python scalar
# as a product with its reciprocal): da within 1e-6 of its largest element
# in fp32, one ulp (2^-7 of the largest element) in bf16. A column sum adds
# R rows in P slices and then the P partials, in the same order on both
# sides; each addition rounds within 2^-24 of the running sum and the terms
# differ by a few ulps at most, so the sums agree within
# (R + P + SUM_TERM_ULPS) 2^-24 of the sum of |term|, plus one bf16 ulp of
# the result where the row is bf16.
BWD_TOL = {torch.float32: 1e-6, torch.bfloat16: 2 ** -7}
SUM_TERM_ULPS = 8


def _assert_col_sum(got, want, terms, what):
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc

    rows = terms.numel() // terms.shape[-1]
    bound = (rows + len(hc.row_slices(rows)) + SUM_TERM_ULPS) * 2.0 ** -24 * hc.column_sums(terms.abs())
    if got.dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * want.float().abs()
    err = (got.float() - want.float()).abs()
    assert bool((err <= bound).all()), f"{what}: {(err - bound).max().item()} over the bound"


def _bwd_case(cuda, sampler, dtype, shape, seed=7):
    """(residual, cotangent) at ``shape``: the sampler's own output on the
    card and a normal cotangent, both in ``dtype``."""
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc

    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.normal(0.5, 2.0, shape).astype(np.float32)).to(cuda, dtype)
    ct = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(cuda, dtype)
    if sampler == "gumbel":
        return fused_samplers.binary_gumbel_sample(a, 0.7, seed=3), ct
    if sampler == "fixed":
        return hc.hard_concrete_sample(a, 2.0 / 3.0, seed=3), ct
    return hc.hard_concrete_learned_sample(a, *_hc_rows(cuda, shape[-1]), seed=3), ct


# (sampler, shape, training): the train steps' shapes, a 3-D leading shape
# and a ragged one for the learned rows' column sums. The Gumbel sampler's
# eval is a threshold with no gradient.
BWD_CASES = [("gumbel", TRAIN_LOGITS, True), ("fixed", HC_LOGITS, True), ("fixed", HC_LOGITS, False),
             ("learned", TRAIN_LOGITS, True), ("learned", TRAIN_LOGITS, False),
             ("learned", (2, 8, 6195), True), ("learned", (2, 8, 6195), False), ("learned", (3, 37), True)]
BWD_CASE_IDS = ["gumbel", "fixed", "fixed-eval", "learned", "learned-eval", "learned3d", "learned3d-eval",
                "learned3x37"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("sampler,shape,training", BWD_CASES, ids=BWD_CASE_IDS)
def test_sampler_backward_kernels_match_plain(cuda, sampler, shape, training, dtype):
    """Each backward kernel against its plain version on the same residual
    and cotangent, launched once a call, two calls bit for bit."""
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc

    x, ct = _bwd_case(cuda, sampler, dtype, shape)
    if sampler == "gumbel":
        wrapper = fused_samplers.binary_gumbel_bwd
        run = lambda: (wrapper(x, ct, 0.7),)  # noqa: E731
        want = (fused_samplers.binary_gumbel_bwd_plain(x, ct, 0.7),)
    elif sampler == "fixed":
        wrapper = hc.hard_concrete_bwd
        run = lambda: (wrapper(x, ct, 2.0 / 3.0, training),)  # noqa: E731
        want = (hc.hard_concrete_bwd_plain(x, ct, 2.0 / 3.0, training),)
    else:
        rows = _hc_rows(cuda, shape[-1])
        wrapper = hc.hard_concrete_learned_bwd
        run = lambda: wrapper(x, ct, *rows, training)  # noqa: E731
        want = hc.hard_concrete_learned_bwd_plain(x, ct, *rows, training)
    before = wrapper.launches
    got = run()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert got[0].dtype == dtype and got[0].shape == x.shape
    err = (got[0].float() - want[0].float()).abs().max().item()
    assert err <= BWD_TOL[dtype] * want[0].float().abs().max().item(), err
    if sampler == "learned":
        _, tb, tg, tz = hc.hard_concrete_learned_terms(x, ct, *rows, training)
        if training:
            _assert_col_sum(got[1], want[1], tb, "dbeta")
        else:
            assert bool((got[1] == 0).all())
        _assert_col_sum(got[2], want[2], tg, "dgamma")
        _assert_col_sum(got[3], want[3], tz, "dzeta")
        assert all(g.shape == (shape[-1],) and g.dtype == torch.float32 for g in got[1:])
    again = run()
    assert all(torch.equal(g, h) for g, h in zip(got, again))


@pytest.mark.parametrize("sampler", ["gumbel", "fixed", "learned"])
def test_sampler_backward_kernels_take_a_cotangent_of_the_other_dtype(cuda, sampler):
    """A bf16 residual with an fp32 cotangent (and the reverse) gives the
    plain version's result in the residual's dtype; bf16 stretch rows give
    bf16 cotangents."""
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc

    for dtype, ct_dtype in ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16)):
        x, ct = _bwd_case(cuda, sampler, dtype, (4, 6195))
        ct = ct.to(ct_dtype)
        if sampler == "gumbel":
            got, want = fused_samplers.binary_gumbel_bwd(x, ct, 0.7), fused_samplers.binary_gumbel_bwd_plain(x, ct, 0.7)
        elif sampler == "fixed":
            got, want = hc.hard_concrete_bwd(x, ct, 0.7, True), hc.hard_concrete_bwd_plain(x, ct, 0.7, True)
        else:
            rows = [r.to(dtype) for r in _hc_rows(cuda, 6195)]
            grads = hc.hard_concrete_learned_bwd(x, ct, *rows, True)
            assert all(g.dtype == dtype for g in grads)
            got, want = grads[0], hc.hard_concrete_learned_bwd_plain(x, ct, *rows, True)[0]
        assert got.dtype == dtype
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BWD_TOL[dtype] * want.float().abs().max().item(), (dtype, err)


def test_hard_concrete_eval_backward_launches_the_kernel(cuda):
    """In eval the forward is the plain noiseless gate, but the backward of
    a CUDA tensor still runs the kernel: no / T and no / beta, dbeta 0."""
    from topo_audio_autoencoder_torch.ops import fused_hard_concrete as hc

    a = torch.linspace(-3.0, 3.0, 6195, device=cuda).repeat(4, 1).requires_grad_(True)
    before = hc.hard_concrete_sample.launches, hc.hard_concrete_bwd.launches
    z = hc.hard_concrete_fused_diff(a, None, 0.7, training=False)
    z.sum().backward()
    assert (hc.hard_concrete_sample.launches, hc.hard_concrete_bwd.launches) == (before[0], before[1] + 1)
    want = hc.hard_concrete_bwd_plain(z.detach(), torch.ones_like(z), 0.7, False)
    assert (a.grad - want).abs().max().item() <= BWD_TOL[torch.float32] * want.abs().max().item()
    rows = [r.requires_grad_(True) for r in _hc_rows(cuda, 6195)]
    before = hc.hard_concrete_learned_sample.launches, hc.hard_concrete_learned_bwd.launches
    hc.hard_concrete_fused_learned_diff(a, None, *rows, training=False).sum().backward()
    assert (hc.hard_concrete_learned_sample.launches, hc.hard_concrete_learned_bwd.launches) == (
        before[0], before[1] + 1)
    assert bool((rows[0].grad == 0).all()) and bool(rows[1].grad.abs().sum() > 0)


# The fused SCCN combine (rows 6-10 of the kernel table). Inputs scaled as
# benchmarks/kernel_diag.make_inputs scales them. fp32: the kernel and the
# plain version differ in summation order only: y within 1e-5 of its largest
# element, every gradient within 1e-4 of its own. bf16: the plain version
# rounds each of its ops to bf16 (about six roundings of 2^-9 between a
# carrier and y, ten on the way to a gradient), the kernel only its outputs
# and three product operands: 2^-5 of the largest element bounds both.
COMBINE_RTOL = {torch.float32: (1e-5, 1e-4), torch.bfloat16: (2 ** -5, 2 ** -5)}
# 37 and 3,000 rows: neither a multiple of the 64-row tile; 32, 33, 96 and
# 4,097 rows: the edges of the kernels' 32-row units and half tiles; 18,240
# and 77,520 rows: the flagship's two fused ranks, on the card's full grid;
# 7,936, 8,192 and 4,096 rows: the n=32 packed model's fused ranks 1-3 at
# B=16 (496 dense edges, 512 and 256 packed rows).
COMBINE_ROWS = [(1, 37), (3, 1000), (32,), (33,), (96,), (4097,), (16, 1140), (77520,), (16, 496), (16, 512),
                (16, 256)]
COMBINE_ROW_IDS = ["37rows", "3000rows", "32rows", "33rows", "96rows", "4097rows", "18240rows", "77520rows",
                   "packed_r1_7936rows", "packed_r2_8192rows", "packed_r3_4096rows"]


def _combine_inputs(cuda, dtype, m, lead, seed=0):
    rng = np.random.default_rng(seed)

    def t(shape, scale=1.0):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(np.float32)).to(cuda, dtype)

    c = 64
    car = tuple(t((*lead, c)) for _ in range(m))
    return car, t((*lead, c)), t((m, c, c), 0.1), t((c, c), 0.1), t((c,), 0.1), t((c, 1), 0.1), t((*lead, c))


def _assert_rel(got, want, rtol, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rtol * scale, (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("lead", COMBINE_ROWS, ids=COMBINE_ROW_IDS)
def test_combine_kernels_match_plain(cuda, dtype, m, lead):
    from topo_audio_autoencoder_torch.ops import sccn_combine as sc

    car, x, v, w1, b1, w2, dy = _combine_inputs(cuda, dtype, m, lead)
    f0, b0 = sc.combine_fwd.launches, sc.combine_bwd.launches
    y = sc.combine_fwd(car, x, v, w1, b1, w2)
    grads = sc.combine_bwd(car, x, v, w1, b1, w2, dy)
    torch.cuda.synchronize()
    assert (sc.combine_fwd.launches, sc.combine_bwd.launches) == (f0 + 1, b0 + 1)
    fwd_tol, bwd_tol = COMBINE_RTOL[dtype]
    _assert_rel(y, sc.message_combine_reference(car, x, v, w1, b1, w2), fwd_tol, "y")
    dcar, *rest = grads
    want_dcar, *want_rest = sc.combine_bwd_plain(car, x, v, w1, b1, w2, dy)
    for i, (g, w) in enumerate(zip(dcar, want_dcar)):
        _assert_rel(g, w, bwd_tol, f"dcar{i}")
    for name, g, w in zip(("dx", "dv", "dw1", "db1", "dw2"), rest, want_rest):
        _assert_rel(g, w, bwd_tol, name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("lead", [(4097,), (16, 1140)], ids=["4097rows", "18240rows"])
def test_combine_kernels_are_deterministic(cuda, dtype, m, lead):
    """Rows 6 and 7 twice on the same inputs: the same bits (no atomics; the
    second pass sums the blocks' partials in block order)."""
    from topo_audio_autoencoder_torch.ops import sccn_combine as sc

    car, x, v, w1, b1, w2, dy = _combine_inputs(cuda, dtype, m, lead, seed=5)
    first = (sc.combine_fwd(car, x, v, w1, b1, w2), sc.combine_bwd(car, x, v, w1, b1, w2, dy))
    second = (sc.combine_fwd(car, x, v, w1, b1, w2), sc.combine_bwd(car, x, v, w1, b1, w2, dy))
    torch.cuda.synchronize()
    assert torch.equal(first[0], second[0])
    (dcar, *rest), (again_dcar, *again_rest) = first[1], second[1]
    for a, b in zip((*dcar, *rest), (*again_dcar, *again_rest)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("m, rows", [(1, 4097), (3, 18240), (2, 77520)], ids=["m1", "m3", "m2"])
def test_combine_bwd_weight_grads_match_the_blocked_plain_sum(cuda, m, rows):
    """The backward kernel's dV, dW1, db1 and dw2 against the same split of
    the rows among its own number of blocks, each range in fp32 and the
    ranges summed in block order (combine_bwd_blocked_plain). Products in
    another order keep this at COMBINE_RTOL: it checks the split, and
    test_combine_kernels_are_deterministic the fixed order."""
    from topo_audio_autoencoder_torch.ops import sccn_combine as sc

    car, x, v, w1, b1, w2, dy = _combine_inputs(cuda, torch.float32, m, (rows,), seed=6)
    blocks = sc.kernel_blocks(rows, m, torch.float32, backward=True)
    assert 1 <= blocks <= -(-rows // sc.ROW_UNIT)
    _, _, *got = sc.combine_bwd(car, x, v, w1, b1, w2, dy)
    _, _, *want = sc.combine_bwd_blocked_plain(car, x, v, w1, b1, w2, dy, blocks)
    for name, g, w in zip(("dv", "dw1", "db1", "dw2"), got, want):
        _assert_rel(g, w, COMBINE_RTOL[torch.float32][1], name)


def test_fused_combine_autograd_goes_through_both_kernels(cuda):
    from topo_audio_autoencoder_torch.ops import sccn_combine as sc

    car, x, v, w1, b1, w2, dy = _combine_inputs(cuda, torch.float32, 3, (2, 1140), seed=1)
    leaves = [t.clone().requires_grad_(True) for t in (*car, x, v, w1, b1, w2)]
    f0, b0 = sc.combine_fwd.launches, sc.combine_bwd.launches
    y = sc.fused_message_combine(tuple(leaves[:3]), *leaves[3:])
    y.backward(dy)
    torch.cuda.synchronize()
    assert (sc.combine_fwd.launches, sc.combine_bwd.launches) == (f0 + 1, b0 + 1)
    dcar, *rest = sc.combine_bwd_plain(car, x, v, w1, b1, w2, dy)
    for leaf, w in zip(leaves, (*dcar, *rest)):
        _assert_rel(leaf.grad, w, 1e-4, "grad")


def test_combine_kernels_refuse_what_they_were_not_built_for(cuda):
    from topo_audio_autoencoder_torch.ops import sccn_combine as sc

    car, x, v, w1, b1, w2, _ = _combine_inputs(cuda, torch.float32, 2, (1, 100))
    with pytest.raises(ValueError):  # C = 32
        sc.combine_fwd(tuple(t[..., :32] for t in car), x[..., :32], v[:, :32, :32], w1[:32, :32],
                       b1[:32], w2[:32])
    with pytest.raises(TypeError):  # mixed dtypes
        sc.combine_fwd(car, x, v.double(), w1, b1, w2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_packed_combine_kernels_match_plain(cuda, dtype):
    """Rows 8 and 9 against their plain versions, and autograd through
    packed_combine launching each once."""
    from topo_audio_autoencoder_torch.ops import combine_diag as cd

    car, x, v, w1, b1, w2, dy = _combine_inputs(cuda, dtype, 2, (3000,), seed=2)
    car = torch.stack(car)
    f0, b0 = cd.packed_combine_fwd.launches, cd.packed_combine_bwd.launches
    y = cd.packed_combine_fwd(car, x, v, w1, b1, w2)
    grads = cd.packed_combine_bwd(car, x, v, w1, b1, w2, dy)
    torch.cuda.synchronize()
    assert (cd.packed_combine_fwd.launches, cd.packed_combine_bwd.launches) == (f0 + 1, b0 + 1)
    fwd_tol, bwd_tol = COMBINE_RTOL[dtype]
    _assert_rel(y, cd.packed_combine_plain(car, x, v, w1, b1, w2), fwd_tol, "y")
    want = cd.packed_combine_bwd_plain(car, x, v, w1, b1, w2, dy)
    for name, g, w in zip(("dcar", "dx", "dv", "dw1", "db1", "dw2"), grads, want):
        _assert_rel(g, w, bwd_tol, name)
    leaves = [t.clone().requires_grad_(True) for t in (car, x, v, w1, b1, w2)]
    cd.packed_combine(*leaves).backward(dy)
    assert (cd.packed_combine_fwd.launches, cd.packed_combine_bwd.launches) == (f0 + 2, b0 + 2)
    for leaf, w in zip(leaves, want):
        _assert_rel(leaf.grad, w, bwd_tol, "packed autograd")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("variant", ["copy", "matmul", "nogelu"])
def test_ablation_kernels_match_plain(cuda, dtype, m, variant):
    """Row 10's three kernels against their plain versions, 3,000 rows."""
    from topo_audio_autoencoder_torch.ops import combine_diag as cd

    car, x, v, w1, b1, w2, _ = _combine_inputs(cuda, dtype, m, (3000,), seed=3)
    car = torch.stack(car)
    args = {"copy": (car, x), "matmul": (car, x, v), "nogelu": (car, x, v, w1, b1, w2)}[variant]
    kernel, plain = getattr(cd, f"combine_{variant}"), getattr(cd, f"combine_{variant}_plain")
    before = kernel.launches
    y = kernel(*args)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    _assert_rel(y, plain(*args), COMBINE_RTOL[dtype][0], variant)


def test_two_packed_steps_repeat_bit_for_bit(cuda):
    """The n=32 packed model (ranks 2-3 packed to 512 and 256 rows), two
    models from one seed, one step's loss and gradient each on the same
    batch, cuDNN deterministic: equal bit for bit (the packed gathers'
    backwards sum in a fixed order; autograd's own added with atomics)."""
    from topo_audio_autoencoder_torch.models import AudioAutoencoder
    from topo_audio_autoencoder_torch.training import make_loss_and_grads

    t, b, g = 16384, 4, 3
    rng = np.random.default_rng(6)
    batch = torch.from_numpy((0.3 * rng.standard_normal((b, g, 1, t))).astype(np.float32)).to(cuda)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = []
        for _ in range(2):
            model = AudioAutoencoder.create(num_vertices=32, max_active_vertices=32, pack_capacities=(0, 0, 512, 256),
                                            num_samples=t, seed=5, device=cuda)
            total, _, grads = make_loss_and_grads(model)(batch, 1.0, 3, 0)
            runs.append((total, grads))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    (ta, ga), (tb, gb) = runs
    assert torch.equal(ta, tb)
    assert [n for n in ga if not torch.equal(ga[n], gb[n])] == []


# The optimizer's multi-tensor clip + Adam (csrc/multi_tensor_adam.cu)
# against the plain per-leaf update on the card. With the norm under the
# clip the two give the same bits. With the clip engaged (the gradient 100
# times larger) the norm is summed in another order, a relative difference
# of ~1e-6 in fp32 over the flagship's 18M elements: each moment is held to
# ADAM_CLIP_RTOL of its leaf's largest, each parameter to ADAM_CLIP_RTOL of
# its leaf's largest change plus one fp32 spacing at its own magnitude (the
# sum p + update rounds to the parameter's spacing, which a change of ~1e-4
# and a parameter of ~1 put at ~1e-4 of the change).
ADAM_CLIP_RTOL = 1e-4
FLAGSHIP = dict(num_vertices=20, num_bands=16, sccn_hidden_dim=64, n_sccn_layers=6)


def _adam_leaves(cuda, shapes, seed, norm, names=None):
    """(grads, params, mu, nu, negated rates) for leaves of ``shapes``:
    seeded normals, the moments of a run some steps in, the gradient scaled
    to the global ``norm``; leaves named ``encoder.*`` (if ``names``) take
    1e-3, the others 1e-4."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    grads = [torch.randn(s, generator=g, device=cuda) for s in shapes]
    scale = norm / float(torch.sqrt(sum((x * x).sum() for x in grads)))
    grads = [x * scale for x in grads]
    params = [torch.randn(s, generator=g, device=cuda) for s in shapes]
    mu = [torch.randn(s, generator=g, device=cuda) * 1e-4 for s in shapes]
    nu = [torch.rand(s, generator=g, device=cuda) * 1e-8 for s in shapes]
    names = names or [f"{'encoder' if i % 2 else 'decoder'}.{i}" for i in range(len(shapes))]
    return grads, params, mu, nu, [-1e-3 if n.startswith("encoder.") else -1e-4 for n in names]


def _aligned_like(t):
    """A copy of ``t`` at the same address modulo 16 bytes."""
    offset = (t.data_ptr() % 16) // 4
    copy = torch.empty(t.numel() + 4, device=t.device)[offset:offset + t.numel()].view(t.shape)
    return copy.copy_(t)


def _adam_both(leaves, count=3):
    """The kernels and the plain version on copies of the same leaves, the
    update's count ``count``: ((params, mu, nu) of each)."""
    from topo_audio_autoencoder_torch.ops import multi_tensor_adam as mta
    from topo_audio_autoencoder_torch.training.train_step import bias_corrections

    grads, params, mu, nu, rates = leaves
    out = []
    for fn in (mta.multi_tensor_clip_adam, mta.clip_adam_plain):
        state = [[_aligned_like(t) for t in ts] for ts in (params, mu, nu)]
        fn(grads, *state, rates, 10.0, bias_corrections(count))
        out.append(state)
    torch.cuda.synchronize()
    return out


def _assert_adam_bits(kernel, plain):
    for what, got, want in zip(("params", "mu", "nu"), kernel, plain):
        differ = [i for i, (a, b) in enumerate(zip(got, want)) if not torch.equal(a, b)]
        assert not differ, (what, differ[:10], len(differ))


@pytest.mark.parametrize("clipped", [False, True], ids=["unclipped", "clipped"])
def test_multi_tensor_adam_matches_the_per_leaf_update_on_the_flagship(cuda, clipped):
    from topo_audio_autoencoder_torch.models import AudioAutoencoder
    from topo_audio_autoencoder_torch.ops import multi_tensor_adam as mta

    model = AudioAutoencoder.create(**FLAGSHIP, num_samples=64000, device=cuda)
    named = dict(model.named_parameters())
    assert len(named) == 315
    leaves = _adam_leaves(cuda, [p.shape for p in named.values()], 1, 100.0 if clipped else 1.0, list(named))
    before = mta.multi_tensor_clip_adam.launches
    kernel, plain = _adam_both(leaves)
    assert mta.multi_tensor_clip_adam.launches == before + 2
    if not clipped:
        _assert_adam_bits(kernel, plain)
        return
    start = leaves[1]
    for i in range(len(start)):
        for what, got, want in zip(("mu", "nu"), kernel[1:], plain[1:]):
            err = (got[i] - want[i]).abs().max().item()
            assert err <= ADAM_CLIP_RTOL * want[i].abs().max().item(), (what, i, err)
        change = (plain[0][i] - start[i]).abs().max().item()
        spacing = torch.nextafter(plain[0][i].abs(), torch.tensor(float("inf"), device=cuda)) - plain[0][i].abs()
        assert bool(((kernel[0][i] - plain[0][i]).abs() <= ADAM_CLIP_RTOL * change + spacing).all()), i


def test_multi_tensor_adam_repeats_bit_for_bit(cuda):
    """Two calls on the same clipped inputs: the same bits (the norm's
    partial sums in a fixed order, no atomics)."""
    from topo_audio_autoencoder_torch.ops import multi_tensor_adam as mta

    grads, params, mu, nu, rates = _adam_leaves(cuda, [(64, 1000), (4097,), (3, 5), (1,)] * 40, 2, 50.0)
    runs = []
    for _ in range(2):
        state = [[t.clone() for t in ts] for ts in (params, mu, nu)]
        mta.multi_tensor_clip_adam(grads, *state, rates, 10.0, (0.1, 0.001))
        runs.append(state)
    torch.cuda.synchronize()
    _assert_adam_bits(runs[0], runs[1])


@pytest.mark.parametrize("case", ["odd", "misaligned", "many"])
def test_multi_tensor_adam_odd_leaves(cuda, case):
    """Leaves of 1 element, of sizes that are not a multiple of 4 or of a
    chunk, empty ones and all-zero gradients (unused leaves); moments that
    are views at odd offsets into one vector (flat_groups: the 4-element
    accesses fall back to single ones); more leaves than one table holds
    (two tables a pass). Unclipped: the plain version's bits."""
    from topo_audio_autoencoder_torch.ops import multi_tensor_adam as mta

    shapes = {"odd": [(1,), (3,), (0,), (5, 7), (4095,), (4096,), (4097,), (2, 4099), (1,)],
              "misaligned": [(1,), (6,), (4097,), (33, 5), (2,)],
              "many": [(i % 37 + 1,) for i in range(2 * mta.MAX_LEAVES + 3)]}[case]
    grads, params, mu, nu, rates = _adam_leaves(cuda, shapes, 3, 1.0)
    grads[0].zero_()
    grads[-1].zero_()
    if case == "misaligned":
        sizes = [t.numel() for t in mu]
        for moments in (mu, nu):
            flat = torch.cat([torch.zeros(1, device=cuda)] + [t.reshape(-1) for t in moments])[1:]
            moments[:] = [v.view(s) for v, s in zip(flat.split(sizes), shapes)]
    before = mta.multi_tensor_clip_adam.launches
    kernel, plain = _adam_both((grads, params, mu, nu, rates))
    assert mta.multi_tensor_clip_adam.launches == before + 2 * len(mta.plan([t.numel() for t in grads]))
    _assert_adam_bits(kernel, plain)


def test_multi_tensor_adam_layouts_agree_bit_for_bit(cuda):
    """The optimizer per leaf and with flat_groups, both through the
    kernels, on the flagship's parameters: 3 updates, the second clipped;
    parameters and moments bit for bit."""
    from topo_audio_autoencoder_torch.models import AudioAutoencoder
    from topo_audio_autoencoder_torch.training import make_optimizer

    models = [AudioAutoencoder.create(**FLAGSHIP, num_samples=64000, seed=5, device=cuda) for _ in range(2)]
    opts = [make_optimizer(accumulate_grad_batches=1, flat_groups=flat) for flat in (False, True)]
    states = [opt.init(m) for opt, m in zip(opts, models)]
    g = torch.Generator(device=cuda).manual_seed(4)
    for scale in (1e-3, 1e2, 1e-3):
        grads = {n: torch.randn(p.shape, generator=g, device=cuda) * scale for n, p in models[0].named_parameters()}
        for opt, state, m in zip(opts, states, models):
            opt.update({n: t.clone() for n, t in grads.items()}, state, m)
    torch.cuda.synchronize()
    for (n, a), b in zip(models[0].named_parameters(), models[1].parameters()):
        assert torch.equal(a, b), n
    per_leaf, flat = states
    for group, names in opts[1].groups(dict(models[0].named_parameters())).items():
        for what in ("mu", "nu"):
            want = torch.cat([getattr(per_leaf, what)[n].reshape(-1) for n in names])
            assert torch.equal(getattr(flat, what)[group], want), (group, what)


def test_multi_tensor_adam_refuses_what_it_does_not_take(cuda):
    from topo_audio_autoencoder_torch.ops import multi_tensor_adam as mta

    grads, params, mu, nu, rates = _adam_leaves(cuda, [(8, 6), (5,)], 6, 1.0)
    for bad, what in ((grads[0].t(), "contiguous"), (grads[0].to(torch.bfloat16), "float32"),
                      (grads[0].reshape(-1)[:40], "sizes")):
        with pytest.raises(ValueError):
            mta.multi_tensor_clip_adam([bad, grads[1]], params, mu, nu, rates, 10.0, (0.1, 0.001))
    with pytest.raises(ValueError):
        mta.multi_tensor_clip_adam(grads, params, [mu[0].double(), mu[1]], nu, rates, 10.0, (0.1, 0.001))
    with pytest.raises(ValueError):
        mta.multi_tensor_clip_adam(grads, [params[0].cpu(), params[1]], mu, nu, rates, 10.0, (0.1, 0.001))
