"""PyTorch port vs the JAX package: static-capacity packed operators
(topology/packed.py) and the packed model.

Packed tensors are never compared in their packed order: ``torch.topk`` and
``jax.lax.top_k`` may order equal keys differently. Each side's result is
scattered back to the full layout through its own ``idx`` (rows outside the
packed set read zero) and compared there. Where the capacities cover the
active rows, packing is exact, and the packed products and model equal the
dense ones.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import WAVE_SEED, flax_params, waveforms

from topo_audio_autoencoder_torch import topology as pt
from topo_audio_autoencoder_torch.convert import state_dict_from_flax
from topo_audio_autoencoder_torch.models import AudioAutoencoder as TorchAutoencoder
from topo_audio_autoencoder_torch.models.encoder import _RowGather
from topo_audio_autoencoder_torch.topology.builder import built_memberships
from topo_audio_autoencoder_torch.topology.packed import _FaceSum, face_sum
from topo_audio_autoencoder_tpu import topology as jt
from topo_audio_autoencoder_tpu.models import AudioAutoencoder as JaxAutoencoder
from topo_audio_autoencoder_tpu.topology.packed import build_packed_operators as jax_build_packed

torch.set_num_threads(1)

# fp32 products against 0/1 memberships and face tables: the packages sum in
# other orders (tests/test_packed.py holds the JAX packed path to 1e-5 too).
TOL = 1e-5
N, C, BATCH = 8, 5, 3


def sparse_complex(rng, tables, keep=0.9):
    """Random downward-closed probabilities per rank (tests/test_packed.py's
    generator, with coins that keep more tetrahedra): a simplex is active
    only if all its faces are and a coin lands heads; active rows get
    probabilities in [0.2, 1]."""
    v = (rng.random(tables.num_vertices) < 0.75).astype(np.float32)
    e = v[tables.edges].prod(-1) * (rng.random(tables.num_edges) < keep)
    t = (e[tables.tri_edges].prod(-1) > 0) * (rng.random(tables.num_triangles) < keep)
    tt = (t[tables.tet_tris].prod(-1) > 0) * (rng.random(tables.num_tetra) < keep)
    return [((0.2 + 0.8 * rng.random(a.shape)) * a).astype(np.float32) for a in (v, e, t, tt)]


def batched_probs(rng, tables, batch):
    rows = [sparse_complex(rng, tables) for _ in range(batch)]
    return [np.stack([r[k] for r in rows]) for k in range(4)]


def unpack_rows(packed, idx, full_size):
    """Packed rows [B, K, ...] back to the full layout [B, full_size, ...]."""
    packed, idx = np.asarray(packed), np.asarray(idx)
    out = np.zeros((packed.shape[0], full_size, *packed.shape[2:]), packed.dtype)
    for b in range(packed.shape[0]):
        out[b, idx[b]] = packed[b]
    return out


def probs_of(ranks, framework):
    if framework == "torch":
        return pt.RectifiedProbs(*(torch.from_numpy(r) for r in ranks))
    return jt.RectifiedProbs(*(jnp.asarray(r) for r in ranks))


@pytest.fixture(scope="module")
def setup():
    tables = pt.build_tables(N)
    ranks = batched_probs(np.random.default_rng(7), tables, BATCH)
    # Capacity = most active rows + 1: covers every active row (exact) and
    # leaves a pad row, so the sentinel path runs too.
    caps = tuple(min(int((r > 0).sum(-1).max()) + 1, s) for r, s in zip(ranks, tables.sizes))
    assert all(c < s for c, s in zip(caps, tables.sizes))
    ops = {
        "dense": pt.build_operators(probs_of(ranks, "torch"), tables),
        "packed": pt.build_packed_operators(probs_of(ranks, "torch"), tables, caps),
        "jax": jax_build_packed(probs_of(ranks, "jax"), jt.build_tables(N), caps),
    }
    feats = [np.random.default_rng(10 + r).standard_normal((BATCH, s, C)).astype(np.float32)
             for r, s in enumerate(tables.sizes)]
    return tables, ranks, caps, ops, feats


# name: (rank of the output, product of the rank-r inputs X).
PRODUCTS = {
    **{f"down{r}": (r, lambda o, X, r=r: o.down(r, X[r - 1])) for r in (1, 2, 3)},
    **{f"up{r}": (r - 1, lambda o, X, r=r: o.up(r, X[r])) for r in (1, 2, 3)},
    "adj0": (0, lambda o, X: o.adj0_matmul(X[0])),
    # The layer's same-rank compositions: up(r+1, down(r+1, x)) - diag x,
    # and for the top rank down(3, up(3, x)) - diag x.
    **{f"same{r}": (r, lambda o, X, r=r: o.up(r + 1, o.down(r + 1, X[r]))
                    - o.gram_diag(r, via_upper=True)[..., None] * X[r]) for r in (1, 2)},
    "same3": (3, lambda o, X: o.down(3, o.up(3, X[3])) - o.gram_diag(3, via_upper=False)[..., None] * X[3]),
    **{f"gram{r}": (r, lambda o, X, r=r: o.gram_diag(r, via_upper=r < 3)[..., None]) for r in range(4)},
}


def run_product(ops, name, feats, sizes):
    """The product on each rank's input in the operator set's layout (a
    packed rank takes its packed rows), scattered back to the full layout."""
    out_rank, fn = PRODUCTS[name]
    idx = getattr(ops, "idx", (None,) * 4)
    is_jax = not isinstance(ops.probs[0], torch.Tensor)
    X = []
    for r, f in enumerate(feats):
        if idx[r] is not None:
            f = np.take_along_axis(f, np.asarray(idx[r])[..., None], axis=1)
        X.append(jnp.asarray(f) if is_jax else torch.from_numpy(f))
    got = np.asarray(fn(ops, X))
    return got if idx[out_rank] is None else unpack_rows(got, idx[out_rank], sizes[out_rank])


@pytest.mark.parametrize("name", list(PRODUCTS))
def test_packed_product_matches_dense_and_jax(setup, name):
    tables, ranks, caps, ops, feats = setup
    dense = run_product(ops["dense"], name, feats, tables.sizes)
    packed = run_product(ops["packed"], name, feats, tables.sizes)
    jax_packed = run_product(ops["jax"], name, feats, tables.sizes)
    assert np.abs(dense).max() > 0
    np.testing.assert_allclose(packed, dense, atol=TOL, err_msg="packed vs dense")
    np.testing.assert_allclose(packed, jax_packed, atol=TOL, err_msg="port vs JAX, packed")


def test_packed_layout_matches_jax(setup):
    """Each active row's probability and face set, found by the full id the
    row holds (the order of equal keys, and so which inactive rows fill the
    capacity, may differ between the packages); a dropped face reads -1."""
    tables, ranks, caps, ops, feats = setup
    p, j = ops["packed"], ops["jax"]

    def rows(o, r, b):
        idx = np.asarray(o.idx[r][b])
        out = {}
        for k in np.flatnonzero(np.asarray(o.masks[r][b])):
            faces = ()
            if r > 0:
                ids = np.append(np.asarray(o.idx[r - 1][b]), -1)
                faces = tuple(sorted(ids[np.asarray(o.faces[r][b][k])]))
            out[int(idx[k])] = (float(o.probs[r][b][k]), faces)
        return out

    for r in range(4):
        assert tuple(p.idx[r].shape) == (BATCH, caps[r])
        assert r == 0 or tuple(p.faces[r].shape) == (BATCH, caps[r], r + 1)
        for b in range(BATCH):
            got = rows(p, r, b)
            assert sorted(got) == list(np.flatnonzero(ranks[r][b]))
            assert got == rows(j, r, b)
    # Every rank is packed here: no dense membership is kept.
    assert p.memberships == (None, None, None)


def test_partial_packing_boundary(setup):
    """Ranks 2-3 packed at half their size (the n=32 model's shape of
    capacities): dense ranks keep the memberships, the boundary products
    mix layouts, and the packed ranks' memberships are never built."""
    tables, ranks, _, ops, feats = setup
    caps = (0, 0, tables.sizes[2] // 2, tables.sizes[3] // 2)
    assert all((r > 0).sum(-1).max() <= c for r, c in zip(ranks[2:], caps[2:]))
    packed = pt.build_packed_operators(probs_of(ranks, "torch"), tables, caps)
    jax_packed = jax_build_packed(probs_of(ranks, "jax"), jt.build_tables(N), caps)
    assert packed.idx[0] is None and packed.idx[1] is None
    assert packed.memberships[0] is not None and packed.memberships[1] is None and packed.memberships[2] is None
    for name in ("down2", "up2", "adj0", "same1", "gram1", "down3"):
        want = run_product(ops["dense"], name, feats, tables.sizes)
        np.testing.assert_allclose(run_product(packed, name, feats, tables.sizes), want, atol=TOL, err_msg=name)
        np.testing.assert_allclose(run_product(jax_packed, name, feats, tables.sizes), want, atol=TOL,
                                   err_msg=name)
    # A complex no dense operator set has touched: packing builds only the
    # dense rank's membership (v2e), never e2t or t2tt.
    fresh = pt.build_tables(9)
    sparse = batched_probs(np.random.default_rng(8), fresh, 2)
    pt.build_packed_operators(probs_of(sparse, "torch"), fresh, (None, None, 16, 8))
    assert built_memberships(9) == [(1, "cpu")]


def test_upward_closure_is_required(setup):
    tables, ranks, *_ = setup
    with pytest.raises(ValueError, match="upward-closed"):
        pt.build_packed_operators(probs_of(ranks, "torch"), tables, (4, 0, 0, 0))


def test_truncation_keeps_the_top_probability_rows(setup):
    tables, ranks, *_ = setup
    packed = pt.build_packed_operators(probs_of(ranks, "torch"), tables, (0, 0, 0, 2))
    assert max((r > 0).sum() for r in ranks[3]) > 2
    for b in range(BATCH):
        kept = packed.idx[3][b].numpy()
        assert ranks[3][b][kept].min() >= np.delete(ranks[3][b], kept).max()
        np.testing.assert_array_equal(packed.probs[3][b].numpy(), np.sort(ranks[3][b])[::-1][:2])


# The packed model of tests/test_packed.py: n=8, 16 bands, C=16, 2 SCCN
# layers, ranks 2-3 packed at half their size (28 of 56 triangles, 35 of 70
# tetrahedra); 4,096-sample clips.
MODEL = dict(num_vertices=8, num_bands=16, sccn_hidden_dim=16, n_sccn_layers=2, max_active_vertices=8)
CAPS = (0, 0, 28, 35)
T = 4096
# fp32 in both packages, XLA's and PyTorch's CPU kernels (tests/test_torch_models.py).
WAVE_ATOL = 1e-4
AUX_ATOL = 1e-5
TRAIN_RNG = 7
# Soft training keeps every simplex active, so the top-K keeps the rows of
# highest rectified probability. A row whose key lies this close to the
# K-th one could change sides between the packages (their probabilities
# differ by ~1e-6): the test asserts the margin first.
SELECT_MARGIN = 1e-4


@pytest.fixture(scope="module")
def models():
    jm = JaxAutoencoder.create(**MODEL, dropout=0.0, pack_capacities=CAPS)
    params = flax_params(jm, num_samples=T)

    def port(**options):
        model = TorchAutoencoder.create(**MODEL, num_samples=T, device="cpu", dropout=0.0, **options)
        model.load_state_dict(state_dict_from_flax(params, model.state_dict()))
        return model

    x = waveforms(WAVE_SEED, 2, T)
    latent = batched_probs(np.random.default_rng(3), pt.build_tables(N), 2)
    rng = jax.random.PRNGKey(TRAIN_RNG)

    @jax.jit
    def run(p, x, latent):
        return (jm.apply(p, x, 1.0, None, False), jm.apply(p, x, 1.0, rng, True),
                jm.apply(p, latent, T // 16, method=lambda m, a, d: m.decode_from_probs(a, d)))

    eval_out, train_out, decoded = run(params, jnp.asarray(x), probs_of(latent, "jax"))
    sample_rng, _ = jax.random.split(rng)
    u = np.array(jax.random.uniform(sample_rng, (2, jm.tables.total_simplices), minval=1e-6, maxval=1.0 - 1e-6))
    return dict(jm=jm, params=params, packed=port(pack_capacities=CAPS), dense=port(), x=x, latent=latent,
                u=u, eval=eval_out, train=train_out, decoded=decoded)


def _assert_forward_matches(got, want):
    np.testing.assert_allclose(got.waveform.numpy(), np.asarray(want.waveform), atol=WAVE_ATOL)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert got.aux.keys() == want.aux.keys()
    for key in want.aux:
        np.testing.assert_allclose(got.aux[key].numpy(), np.asarray(want.aux[key]), atol=AUX_ATOL, err_msg=key)
    for g, w in zip(got.encoder_output.probs.ranks, want.encoder_output.probs):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


def test_packed_model_eval_matches_jax_and_the_dense_model(models):
    m = models
    with torch.no_grad():
        got = m["packed"](torch.from_numpy(m["x"]))
        dense = m["dense"](torch.from_numpy(m["x"]))
    # The eval latent's triangles and tetrahedra fit the capacities: packing is exact.
    active = [int(p.sum(-1).max()) for p in got.encoder_output.probs.ranks]
    assert 0 < active[2] <= CAPS[2] and 0 < active[3] <= CAPS[3], active
    _assert_forward_matches(got, m["eval"])
    np.testing.assert_allclose(got.waveform.numpy(), dense.waveform.numpy(), atol=WAVE_ATOL)
    # Packed tensors in the encoder output: K rows of ranks 2-3, full rows below.
    enc = got.encoder_output
    assert [e.shape[1] for e in enc.embeddings] == [8, 28, 28, 35]
    assert [mk.shape[1] for mk in enc.masks] == [8, 28, 28, 35]
    assert [p.shape[1] for p in enc.probs.ranks] == [8, 28, 56, 70]


def test_packed_model_train_forward_matches_jax(models):
    """Train mode on JAX's uniforms: soft probabilities everywhere, so ranks
    2-3 keep their K rows of highest rectified probability."""
    m = models
    with torch.no_grad():
        got = m["packed"](torch.from_numpy(m["x"]), 1.0, train=True, noise=torch.from_numpy(m["u"]))
    rect = got.encoder_output.rectified.ranks
    for r in (2, 3):
        key = np.sort(rect[r].numpy() + (rect[r].numpy() > 0), axis=-1)[:, ::-1]
        margin = float((key[:, CAPS[r] - 1] - key[:, CAPS[r]]).min())
        assert margin > SELECT_MARGIN, f"rank {r}: the K-th and (K+1)-th keys are {margin} apart"
    _assert_forward_matches(got, m["train"])


def test_packed_decode_from_probs_matches_jax_and_the_dense_model(models):
    m = models
    latent = probs_of(m["latent"], "torch")
    with torch.no_grad():
        got = m["packed"].decode_from_probs(latent, T // 16)
        dense = m["dense"].decode_from_probs(latent, T // 16)
    assert got.shape == (2, 1, T)
    np.testing.assert_allclose(got.numpy(), np.asarray(m["decoded"]), atol=WAVE_ATOL)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=WAVE_ATOL)


def test_packed_geometry_and_parameters_match_jax(models):
    m = models
    assert m["packed"].geometry() == m["jm"].geometry()
    assert m["packed"].geometry()["pack_capacities"] == list(CAPS)
    assert m["packed"].num_params() == m["jm"].num_params(m["params"]) == m["dense"].num_params()


# The packed gathers' fixed-order backwards (``_FaceSum``, ``_RowGather``)
# against autograd's own backward of the same gathers: sums of the same
# terms in another order, so fp32 round-off apart.
GATHER_BWD_RTOL = 1e-6


def _old_face_gather(ops, rank, x):
    """The face gather as autograd differentiates it (take_along_dim + sum)."""
    return face_sum(x, ops.faces[rank], ops.is_packed(rank - 1))


def _rel(got, want):
    return float((got - want).norm() / want.norm())


@pytest.mark.parametrize("rank", [1, 2, 3])
def test_packed_face_gather_forward_bit_for_bit_and_its_fixed_order_backward(setup, rank):
    """``_gather_faces`` equals the gather it replaced bit for bit; its
    backward, the product with the face one-hot, equals autograd's backward
    of the gather (a face shared by packed simplices, sentinel faces that
    take no gradient) within GATHER_BWD_RTOL."""
    tables, ranks, caps, ops, feats = setup
    packed = ops["packed"]
    lower = packed.face_onehots[rank].shape[-2]
    x = torch.from_numpy(np.random.default_rng(rank).standard_normal((BATCH, lower, C)).astype(np.float32))
    ct = torch.from_numpy(np.random.default_rng(9 + rank).standard_normal(
        (BATCH, packed.faces[rank].shape[-2], C)).astype(np.float32))
    x1, x2 = x.clone().requires_grad_(), x.clone().requires_grad_()
    got, want = packed._gather_faces(rank, x1), _old_face_gather(packed, rank, x2)
    assert torch.equal(got, want)
    (g1,) = torch.autograd.grad(got, x1, ct)
    (g2,) = torch.autograd.grad(want, x2, ct)
    assert _rel(g1, g2) <= GATHER_BWD_RTOL
    # Faces shared by several packed simplices: the sums the atomics made.
    faces = packed.faces[rank]
    shared = max(int(torch.bincount(f.reshape(-1)).max()) for f in faces)
    assert shared > 1


def test_packed_embedding_gather_forward_bit_for_bit_and_its_fixed_order_backward():
    """``_RowGather`` (the packed rank's embedding gather) equals
    ``table[idx]`` bit for bit, and its backward equals autograd's
    backward of the index within GATHER_BWD_RTOL, with table rows that
    several samples select."""
    rng = np.random.default_rng(4)
    table = torch.from_numpy(rng.standard_normal((40, C)).astype(np.float32))
    idx = torch.stack([torch.from_numpy(rng.permutation(40)[:12]) for _ in range(5)])
    assert int(torch.bincount(idx.reshape(-1)).max()) > 1
    ct = torch.from_numpy(rng.standard_normal((5, 12, C)).astype(np.float32))
    t1, t2 = table.clone().requires_grad_(), table.clone().requires_grad_()
    got, want = _RowGather.apply(t1, idx), t2[idx]
    assert torch.equal(got, want)
    (g1,) = torch.autograd.grad(got, t1, ct)
    (g2,) = torch.autograd.grad(want, t2, ct)
    assert _rel(g1, g2) <= GATHER_BWD_RTOL


def test_packed_gathers_under_vmap_equal_their_unbatched_calls(setup):
    """The vmapped tuner's path: both Functions under ``torch.func.vmap``
    (every input vmapped, as each combo packs its own rows) equal one call
    per combo, forward and gradient, bit for bit."""
    tables, ranks, caps, ops, feats = setup
    packed = ops["packed"]
    k, rank = 2, 2
    lower = packed.face_onehots[rank].shape[-2]
    rng = np.random.default_rng(12)
    faces = packed.faces[rank].expand(k, *packed.faces[rank].shape)
    onehots = packed.face_onehots[rank].expand(k, *packed.face_onehots[rank].shape)
    x = torch.from_numpy(rng.standard_normal((k, BATCH, lower, C)).astype(np.float32)).requires_grad_()
    table = torch.from_numpy(rng.standard_normal((k, 40, C)).astype(np.float32)).requires_grad_()
    idx = torch.from_numpy(np.stack([[rng.permutation(40)[:12] for _ in range(BATCH)] for _ in range(k)]))
    sentinel = packed.is_packed(rank - 1)
    vf = torch.func.vmap(lambda a, f, o: _FaceSum.apply(a, f, o, sentinel))(x, faces, onehots)
    vr = torch.func.vmap(_RowGather.apply)(table, idx)
    loop_f = torch.stack([_FaceSum.apply(x[i], faces[i], onehots[i], sentinel) for i in range(k)])
    loop_r = torch.stack([_RowGather.apply(table[i], idx[i]) for i in range(k)])
    assert torch.equal(vf, loop_f) and torch.equal(vr, loop_r)
    ct_f, ct_r = torch.randn_like(vf), torch.randn_like(vr)
    assert all(torch.equal(a, b) for a, b in zip(torch.autograd.grad((vf, vr), (x, table), (ct_f, ct_r)),
                                                   torch.autograd.grad((loop_f, loop_r), (x, table), (ct_f, ct_r))))
