"""PyTorch port vs the JAX package: complex tables, rectifier, operators."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch import topology as pt
from topo_audio_autoencoder_tpu import topology as jt
from topo_audio_autoencoder_tpu.topology.builder import (
    build_operators as jax_build_operators,
)

torch.set_num_threads(1)

_FIELDS = ("edges", "triangles", "tetra", "tri_edges", "tet_tris", "v2e", "e2t", "t2tt")


@pytest.mark.parametrize("n", [5, 20])
def test_tables_match(n):
    a, b = pt.build_tables(n), jt.build_tables(n)
    assert a.sizes == b.sizes and a.offsets == b.offsets
    for name in _FIELDS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
    flat = np.arange(b.total_simplices)
    for x, y in zip(a.split(flat), b.split(flat)):
        np.testing.assert_array_equal(x, y)


def _probs(rng, tables, batch=3, zero_frac=0.3):
    """Uniform probs with exact zeros, and one vertex set exactly zero in
    every row, so that zero propagation runs through every rank."""
    p = rng.uniform(size=(batch, tables.total_simplices)).astype(np.float32)
    p[p < zero_frac] = 0.0
    p[:, 0] = 0.0
    return p


def test_rectifier_matches_jax_with_exact_zeros():
    tables = pt.build_tables(6)
    p = _probs(np.random.default_rng(0), tables)
    got = pt.enforce_constraints_flat(torch.from_numpy(p), tables)
    want = jt.enforce_constraints_flat(jnp.asarray(p), jt.build_tables(6))
    for g, w in zip(got.ranks, want.ranks):
        w = np.asarray(w)
        # Same fp32 log/mean/exp chain; the means may sum in another order.
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-7)
        np.testing.assert_array_equal(g.numpy() == 0.0, w == 0.0)
    assert (got.edges.numpy() == 0.0).sum() > (p[:, 6:21] == 0.0).sum()  # zeros propagated
    viol = pt.constraint_violations(got, tables)
    assert viol["edge_zero_face"] == viol["triangle_zero_face"] == viol["tetra_zero_face"] == 0.0


def test_rectifier_keeps_dtype_and_computes_in_fp32():
    tables = pt.build_tables(5)
    p = torch.from_numpy(_probs(np.random.default_rng(1), tables)).to(torch.bfloat16)
    got = pt.enforce_constraints_flat(p, tables)
    assert all(r.dtype == torch.bfloat16 for r in got.ranks)
    want = pt.enforce_constraints_flat(p.to(torch.float32), tables)
    for g, w in zip(got.ranks, want.ranks):
        torch.testing.assert_close(g, w.to(torch.bfloat16), rtol=0, atol=0)


def test_constraint_violations_match_jax():
    tables = pt.build_tables(6)
    # Raw, unrectified probs: the checker must report real violations.
    p = _probs(np.random.default_rng(2), tables)
    v, e, t, tt = tables.split(p)
    got = pt.constraint_violations(
        pt.RectifiedProbs(*(torch.from_numpy(r) for r in (v, e, t, tt))), tables
    )
    want = jt.constraint_violations(
        jt.RectifiedProbs(*(jnp.asarray(r) for r in (v, e, t, tt))), jt.build_tables(6)
    )
    assert got.keys() == want.keys()
    assert got["edge_zero_face"] > 0.0
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6, err_msg=key)


def test_builder_products_match_jax():
    n, c = 6, 4
    tables = pt.build_tables(n)
    rng = np.random.default_rng(3)
    rect_np = np.array(
        jt.enforce_constraints_flat(jnp.asarray(_probs(rng, tables)), jt.build_tables(n)).all_simplices
    )
    ranks = tables.split(rect_np)
    ops_t = pt.build_operators(pt.RectifiedProbs(*(torch.from_numpy(r) for r in ranks)), tables)
    ops_j = jax_build_operators(jt.RectifiedProbs(*(jnp.asarray(r) for r in ranks)), jt.build_tables(n))
    for m_t, m_j in zip(ops_t.memberships, ops_j.memberships):
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    for m_t, m_j in zip(ops_t.masks, ops_j.masks):
        np.testing.assert_array_equal(m_t.numpy(), np.asarray(m_j))
    feats = [rng.standard_normal((3, s, c)).astype(np.float32) for s in tables.sizes]

    def close(got, want):
        # fp32 matmuls against 0/1 memberships; only the summation order differs.
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)

    for r in (1, 2, 3):
        close(ops_t.up(r, torch.from_numpy(feats[r])), ops_j.up(r, jnp.asarray(feats[r])))
        close(ops_t.down(r, torch.from_numpy(feats[r - 1])), ops_j.down(r, jnp.asarray(feats[r - 1])))
    close(ops_t.adj0_matmul(torch.from_numpy(feats[0])), ops_j.adj0_matmul(jnp.asarray(feats[0])))
    for r in (1, 2):
        close(ops_t.gram_diag(r, via_upper=True), ops_j.gram_diag(r, via_upper=True))
    close(ops_t.gram_diag(3, via_upper=False), ops_j.gram_diag(3, via_upper=False))
