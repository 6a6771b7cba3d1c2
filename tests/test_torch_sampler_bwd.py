"""The samplers' closed-form backward in the PyTorch port against the JAX
package's custom VJPs (``_bg_bwd``, ``_hc_bwd``, ``_hcl_bwd`` in
``ops/pallas_kernels.py``), on the same residual and cotangent made with
numpy from a seed; the backward kernels' fixed-order column sum against
``torch.sum``; and the backward wrappers on CPU tensors (the plain versions,
no launch). The kernels themselves run in ``tests/test_torch_kernels.py``
on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch.ops import fused_hard_concrete as pt_hc
from topo_audio_autoencoder_torch.ops import fused_samplers as pt_fused
from topo_audio_autoencoder_tpu.ops import pallas_kernels as jax_pk

torch.set_num_threads(1)

DTYPES = {"fp32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}
T = 0.7
GAMMA, ZETA = -0.1, 1.1
# da against JAX, relative to its largest element. fp32: the same fp32
# operations in the same order, but for the stretch (zeta - gamma) / T,
# which the port rounds once from doubles and JAX in fp32 (a few ulps).
# bf16: JAX rounds s, 1 - s and each product to bf16 (2^-9 each; an error
# in s of 2^-9 moves s (1 - s) by up to |1 - 2 s| 2^-9), the port only its
# output (one ulp, at most 2^-7 of the element): 2^-5 bounds both.
DA_TOL = {"fp32": 1e-6, "bf16": 2 ** -5}
# The stretch rows' column sums against JAX, relative to the column's sum
# of |term|. fp32: both add the same fp32 terms (within a few ulps) in other
# orders; each addition rounds within 2^-24 of the running sum, so R rows in
# P slices differ by at most 2 (R + P) 2^-24 plus the terms' own ulps. bf16:
# JAX rounds each term's operands and products to bf16 as above (2^-5).
# Its bf16 logit s = log s - log1p(-s) has an absolute error of up to
# 2^-9 (|log s| + |log(1 - s)| + 1 / (1 - s)) <= 2^-9 26 for the gates
# inside the clip (s in [0.05, 0.95]), which cancellation near s = 1/2 does
# not shrink: dbeta is held against the sum of |ct sp (zeta - gamma) /
# beta|, its terms without the logit, within 2^-4.
SUM_TERM_ULPS = 8
SUM_TOL_BF16 = 2 ** -5
DBETA_TOL_BF16 = 2 ** -4


def _hc_residual(rng, shape, span, gamma):
    """Gates z = clip(s span + gamma, 0, 1) for s over (0, 1): both clips
    and the inside occur."""
    s = rng.uniform(0.0, 1.0, shape)
    return np.clip(s * span + gamma, 0.0, 1.0).astype(np.float32)


def _pair(x, name):
    """The same numbers as a torch and a JAX array in ``name``'s dtype."""
    tdt, jdt = DTYPES[name]
    return torch.from_numpy(x).to(tdt), jnp.asarray(x).astype(jdt)


def _max_rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_binary_gumbel_bwd_plain_matches_jax(name):
    rng = np.random.default_rng(0)
    s = (1.0 / (1.0 + np.exp(-rng.normal(0.0, 2.0, (4, 37))))).astype(np.float32)
    ct = rng.standard_normal((4, 37)).astype(np.float32)
    (st, sj), (ctt, ctj) = _pair(s, name), _pair(ct, name)
    want, _, _ = jax_pk._bg_bwd(True, (sj, jnp.asarray(T, jnp.float32)), ctj)
    got = pt_fused.binary_gumbel_bwd_plain(st, ctt, T)
    assert got.dtype == st.dtype and want.dtype == sj.dtype
    assert _max_rel(got.float(), want.astype(jnp.float32)) <= DA_TOL[name]


@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_hard_concrete_bwd_plain_matches_jax(name, training):
    rng = np.random.default_rng(1)
    z = _hc_residual(rng, (4, 37), ZETA - GAMMA, GAMMA)
    ct = rng.standard_normal(z.shape).astype(np.float32)
    (zt, zj), (ctt, ctj) = _pair(z, name), _pair(ct, name)
    sj = jnp.clip((zj - GAMMA) / (ZETA - GAMMA), 1e-6, 1.0 - 1e-6)  # _hc_fwd's residual
    want, _, _ = jax_pk._hc_bwd(training, (zj, sj, jnp.asarray(T, jnp.float32)), ctj)
    got = pt_hc.hard_concrete_bwd_plain(zt, ctt, T, training)
    assert got.dtype == zt.dtype
    assert _max_rel(got.float(), want.astype(jnp.float32)) <= DA_TOL[name]
    assert bool((got[(zt == 0) | (zt == 1)] == 0).all())  # clipped gates take none


@pytest.mark.parametrize("shape", [(4, 37), (2, 3, 37)], ids=["2d", "3d"])
@pytest.mark.parametrize("training", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("name", ["fp32", "bf16"])
def test_hard_concrete_learned_bwd_plain_matches_jax(name, training, shape):
    rng = np.random.default_rng(2)
    cols = shape[-1]
    beta = rng.uniform(0.4, 1.0, cols).astype(np.float32)
    gamma = (-rng.uniform(0.05, 0.2, cols)).astype(np.float32)
    zeta = (1.0 + rng.uniform(0.05, 0.2, cols)).astype(np.float32)
    z = _hc_residual(rng, shape, zeta - gamma, gamma)
    ct = rng.standard_normal(shape).astype(np.float32)
    pairs = [_pair(x, name) for x in (z, beta, gamma, zeta, ct)]
    pt, jx = [p[0] for p in pairs], [p[1] for p in pairs]
    want = jax_pk._hcl_bwd(training, False, tuple(jx[:4]), jx[4])
    want = [want[0], *want[2:]]
    got = pt_hc.hard_concrete_learned_bwd_plain(pt[0], pt[4], *pt[1:4], training)
    assert [g.dtype for g in got] == [t.dtype for t in pt[:4]]
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert _max_rel(got[0].float(), want[0].astype(jnp.float32)) <= DA_TOL[name]
    # The sums, each against its columns' sum of |term| (fp32 terms).
    da, tb, tg, tz = pt_hc.hard_concrete_learned_terms(pt[0], pt[4], *pt[1:4], training)
    rows = z.size // cols
    fp32_tol = (2 * (rows + len(pt_hc.row_slices(rows))) + SUM_TERM_ULPS) * 2.0 ** -24
    for label, g, w, terms in (("dbeta", got[1], want[1], tb), ("dgamma", got[2], want[2], tg),
                               ("dzeta", got[3], want[3], tz)):
        w = torch.from_numpy(np.array(w.astype(jnp.float32)))
        if terms is None:  # eval: dbeta is 0
            assert bool((g == 0).all()) and bool((w == 0).all()), label
            continue
        if name == "fp32":
            bound = fp32_tol * pt_hc.column_sums(terms.abs())
        elif label == "dbeta":
            bound = DBETA_TOL_BF16 * pt_hc.column_sums(da.abs())
        else:
            bound = SUM_TOL_BF16 * pt_hc.column_sums(terms.abs())
        assert bool(((g.float() - w).abs() <= bound).all()), label


@pytest.mark.parametrize("shape", [(1, 5), (3, 5), (16, 37), (37, 11), (2, 8, 13)])
def test_column_sums_match_torch_sum(shape):
    """The kernels' order (row slices in order, then the slices' partials)
    against torch.sum: each is within (R + P) 2^-24 of the exact sum, scaled
    by the column's sum of |t|, so they differ by at most twice that."""
    t = torch.from_numpy(np.random.default_rng(3).standard_normal(shape).astype(np.float32))
    rows = t.numel() // shape[-1]
    slices = pt_hc.row_slices(rows)
    p = len(slices)
    assert p & (p - 1) == 0 and p <= min(pt_hc.MAX_SLICES, rows)
    assert slices[0][0] == 0 and slices[-1][1] == rows
    assert all(a[1] == b[0] for a, b in zip(slices, slices[1:]))
    got = pt_hc.column_sums(t)
    want = t.sum(dim=tuple(range(t.ndim - 1)))
    bound = 2 * (rows + p) * 2.0 ** -24 * t.abs().reshape(rows, -1).sum(0)
    assert got.shape == want.shape
    assert bool(((got - want).abs() <= bound).all())
    # One row a slice up to MAX_SLICES rows: the sum is exact for two rows.
    if rows == 1:
        assert torch.equal(got, t.reshape(-1))


def test_sampler_bwd_wrappers_on_cpu():
    """CPU tensors take the plain versions, bit for bit, and launch nothing;
    the wrappers refuse what the kernels do not take."""
    rng = np.random.default_rng(4)
    s = torch.from_numpy(rng.uniform(0.0, 1.0, (4, 37)).astype(np.float32))
    z = torch.from_numpy(_hc_residual(rng, (4, 37), ZETA - GAMMA, GAMMA))
    ct = torch.from_numpy(rng.standard_normal((4, 37)).astype(np.float32))
    rows = [torch.full((37,), v) for v in (T, GAMMA, ZETA)]
    before = (pt_fused.binary_gumbel_bwd.launches, pt_hc.hard_concrete_bwd.launches,
              pt_hc.hard_concrete_learned_bwd.launches)
    assert torch.equal(pt_fused.binary_gumbel_bwd(s, ct, T), pt_fused.binary_gumbel_bwd_plain(s, ct, T))
    assert torch.equal(pt_hc.hard_concrete_bwd(z, ct, T, True), pt_hc.hard_concrete_bwd_plain(z, ct, T, True))
    got = pt_hc.hard_concrete_learned_bwd(z, ct, *rows, True)
    for g, w in zip(got, pt_hc.hard_concrete_learned_bwd_plain(z, ct, *rows, True)):
        assert torch.equal(g, w)
    assert (pt_fused.binary_gumbel_bwd.launches, pt_hc.hard_concrete_bwd.launches,
            pt_hc.hard_concrete_learned_bwd.launches) == before
    # Rows of the fixed stretch give the fixed gradient to log-alpha.
    torch.testing.assert_close(got[0], pt_hc.hard_concrete_bwd(z, ct, T, True), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="cotangent"):
        pt_fused.binary_gumbel_bwd(s, ct[:, :5], T)
    with pytest.raises(ValueError, match="positive"):
        pt_hc.hard_concrete_bwd(z, ct, 0.0, True)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pt_fused.binary_gumbel_bwd(s.to("meta"), ct.to("meta"), T)
    with pytest.raises(ValueError, match="row"):
        pt_hc.hard_concrete_learned_bwd(z, ct, rows[0][:5], *rows[1:], True)
