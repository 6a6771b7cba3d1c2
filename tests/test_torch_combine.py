"""The port's fused SCCN combine against the JAX package on the CPU: the op
against the Pallas kernels in interpret mode (forward and all six
cotangents, M = 1, 2, 3, a ragged row count), the SCCN layer with
``fused_combine`` against the JAX layer and against its own reference path,
the layer's routing at MIN_FUSED_ROWS, and the plain versions of the
kernel_diag variants (packed forward and backward, copy, matmul, no-gelu)
against kernel_diag's kernels in interpret mode.

On the CPU the wrappers take the plain versions; the kernels themselves
are held against those on the card (tests/test_torch_kernels.py).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import random_tree

from topo_audio_autoencoder_torch.convert import state_dict_from_flax
from topo_audio_autoencoder_torch.models import sccn as port_sccn
from topo_audio_autoencoder_torch.ops import combine_diag
from topo_audio_autoencoder_torch.ops import sccn_combine as port_combine
from topo_audio_autoencoder_torch.topology import SimplicialOperators
from topo_audio_autoencoder_tpu.ops import sccn_combine as jax_combine

torch.set_num_threads(1)

# fp32 on both sides, the same operations in other summation orders: the
# tolerances of the JAX package's own kernel tests (tests/test_ops.py).
FWD_TOL = 2e-5
BWD_TOL = 2e-4
GRADS = ("dcar", "dx", "dv", "dw1", "db1", "dw2")


def _inputs(m, b=2, s=37, c=16, seed=0):
    """b * s = 74 rows: not a multiple of any tile."""
    rng = np.random.default_rng(seed)
    car = (rng.standard_normal((m, b, s, c))).astype(np.float32)
    x = rng.standard_normal((b, s, c)).astype(np.float32)
    v = (rng.standard_normal((m, c, c)) * 0.3).astype(np.float32)
    w1 = (rng.standard_normal((c, c)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal((c,)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((c, 1)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((b, s, c)).astype(np.float32)
    return car, x, v, w1, b1, w2, dy


def _torch_leaves(car, x, v, w1, b1, w2):
    return [torch.from_numpy(a).requires_grad_(True) for a in (*car, x, v, w1, b1, w2)]


@pytest.mark.parametrize("m", [1, 2, 3])
def test_fused_combine_matches_jax_kernels(m):
    """Forward against _fwd_call, backward against _bwd_call, both in
    interpret mode on JAX's row-padded layout; the CPU never counts a launch."""
    car, x, v, w1, b1, w2, dy = _inputs(m)
    _, b, s, c = car.shape
    car2, x2 = jax_combine._flatten_pad(jnp.asarray(car), jnp.asarray(x))
    args = (car2, x2, jnp.asarray(v), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2))
    want_y = np.asarray(jax_combine._fwd_call(*args, interpret=True))[: b * s].reshape(b, s, c)
    dy2 = jnp.pad(jnp.asarray(dy).reshape(b * s, c), ((0, car2.shape[1] - b * s), (0, 0)))
    dcar, dx, dv, dw1, db1, dw2 = jax_combine._bwd_call(*args, dy2, interpret=True)
    want = (
        np.asarray(dcar)[:, : b * s].reshape(m, b, s, c),
        np.asarray(dx)[: b * s].reshape(b, s, c),
        np.asarray(dv),
        np.asarray(dw1),
        np.asarray(db1).reshape(c),
        np.asarray(dw2).reshape(c, 1),
    )

    launches = port_combine.combine_fwd.launches, port_combine.combine_bwd.launches
    leaves = _torch_leaves(car, x, v, w1, b1, w2)
    y = port_combine.fused_message_combine(tuple(leaves[:m]), *leaves[m:])
    np.testing.assert_allclose(y.detach().numpy(), want_y, rtol=FWD_TOL, atol=FWD_TOL)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    got = (torch.stack(grads[:m]), *grads[m:])
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape, name
        np.testing.assert_allclose(g.numpy(), w, rtol=BWD_TOL, atol=BWD_TOL, err_msg=name)
    assert (port_combine.combine_fwd.launches, port_combine.combine_bwd.launches) == launches


def test_combine_wrappers_take_the_plain_versions_on_the_cpu():
    """combine_fwd / combine_bwd on CPU tensors equal the reference and
    autograd through it exactly, keep each input's dtype, and refuse
    mismatched shapes."""
    car, x, v, w1, b1, w2, dy = _inputs(2, seed=4)
    leaves = _torch_leaves(car, x, v, w1, b1, w2)
    cars, rest = tuple(leaves[:2]), leaves[2:]
    y = port_combine.combine_fwd(cars, *rest)
    assert torch.equal(y, port_combine.message_combine_reference(cars, *rest))
    dcar, *grads = port_combine.combine_bwd(cars, *rest, torch.from_numpy(dy))
    want = torch.autograd.grad(port_combine.message_combine_reference(cars, *rest), leaves, torch.from_numpy(dy))
    for g, w in zip((*dcar, *grads), want):
        assert torch.equal(g, w)
    with pytest.raises(ValueError):
        port_combine.combine_fwd(cars, *rest[:1], rest[1][:1], *rest[2:])  # v of the wrong M
    with pytest.raises(ValueError):
        port_combine.combine_fwd((cars[0], cars[1][:, :5]), *rest)


N20 = 20  # the flagship complex: rank 3 has 4,845 rows per clip, rank 2 1,140
LAYER_C = 8


@pytest.fixture(scope="module")
def n20_layer():
    """One non-final SCCN layer at C=8 over a random n=20 complex (batch 1):
    the JAX layer with fused_combine=True, its parameters, operators and
    features, and the port's operators and features."""
    from topo_audio_autoencoder_torch import topology as pt
    from topo_audio_autoencoder_tpu import topology as jt
    from topo_audio_autoencoder_tpu.models import GradientSCCNLayer as JaxLayer

    tables, jtables = pt.build_tables(N20), jt.build_tables(N20)
    rng = np.random.default_rng(20)
    probs = rng.uniform(size=(1, tables.total_simplices)).astype(np.float32)
    probs[probs < 0.1] = 0.0
    rect = np.array(jt.enforce_constraints_flat(jnp.asarray(probs), jtables).all_simplices)
    ranks = tables.split(rect)
    masks = [(r > 0).astype(np.float32) for r in ranks]
    jops = jt.build_operators(jt.RectifiedProbs(*(jnp.asarray(r) for r in ranks)), jtables,
                              tuple(jnp.asarray(mk) for mk in masks))
    tops = pt.build_operators(pt.RectifiedProbs(*(torch.from_numpy(r) for r in ranks)), tables,
                              tuple(torch.from_numpy(mk) for mk in masks))
    feats = [rng.standard_normal((1, s, LAYER_C)).astype(np.float32) for s in tables.sizes]
    layer = JaxLayer(channels=LAYER_C, fused_combine=True)
    shapes = jax.eval_shape(lambda: layer.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats], jops, True))
    params = random_tree(shapes, 21)
    return layer, params, jops, tops, feats


def _port_layer(params, fused):
    layer = port_sccn.GradientSCCNLayer(LAYER_C, fused_combine=fused)
    layer.load_state_dict(state_dict_from_flax(params, layer.state_dict()))
    return layer


def test_fused_layer_matches_jax_layer_and_its_reference_path(n20_layer, monkeypatch):
    """Train mode (LayerNorm on), B=1: rank 3 (4,845 rows) takes the fused
    op, rank 2 (1,140) does not. Outputs against the JAX layer with
    fused_combine=True; outputs and every parameter gradient of a fixed
    linear functional against the port's fused_combine=False layer and
    against jax.grad of the JAX layer."""
    jlayer, params, jops, tops, feats = n20_layer
    rng = np.random.default_rng(22)
    weights = [rng.standard_normal(f.shape).astype(np.float32) for f in feats]

    def objective(p):
        out = jlayer.apply(p, [jnp.asarray(f) for f in feats], jops, True)
        return sum(jnp.sum(o * w) for o, w in zip(out, weights)), out

    (_, want_out), want_grads = jax.jit(jax.value_and_grad(objective, has_aux=True))(params)
    want_grads = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, want_grads),
                                      _port_layer(params, False).state_dict())

    calls = []
    real = port_sccn.fused_message_combine

    def spy(carriers, x, *rest):
        calls.append((len(carriers), tuple(x.shape)))
        return real(carriers, x, *rest)

    monkeypatch.setattr(port_sccn, "fused_message_combine", spy)
    results = {}
    for fused in (True, False):
        layer = _port_layer(params, fused)
        out = layer([torch.from_numpy(f) for f in feats], tops, train=True)
        total = sum((o * torch.from_numpy(w)).sum() for o, w in zip(out, weights))
        names, leaves = zip(*layer.named_parameters())
        results[fused] = out, dict(zip(names, torch.autograd.grad(total, leaves)))
    assert calls == [(2, (1, 4845, LAYER_C))]  # the fused layer's rank 3 only

    (f_out, f_grads), (r_out, r_grads) = results[True], results[False]
    for got, ref, want in zip(f_out, r_out, want_out):
        np.testing.assert_allclose(got.detach().numpy(), ref.detach().numpy(), rtol=1e-6, atol=1e-6)
        # Membership products over up to 4,845 rows in other orders, then
        # LayerNorm: ~1e-6 measured; a decade of room.
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    scale = max(float(g.abs().max()) for g in r_grads.values())
    for name, g in f_grads.items():
        np.testing.assert_allclose(g.numpy(), r_grads[name].numpy(), rtol=1e-6, atol=1e-6 * scale, err_msg=name)
        # Sums over all 6,195 simplices in other orders, relative to the
        # largest gradient element.
        np.testing.assert_allclose(g.numpy(), want_grads[name].numpy(), atol=1e-4 * scale, err_msg=name)


def _stub_ops(sizes, seed=5):
    """Factored operators over random 0/1 memberships of any sizes, batch 1."""
    rng = np.random.default_rng(seed)
    probs = tuple(torch.from_numpy(rng.uniform(0.2, 1.0, (1, s)).astype(np.float32)) for s in sizes)
    memberships = tuple(
        torch.from_numpy((rng.uniform(size=(sizes[r], sizes[r - 1])) < 0.3).astype(np.float32))
        for r in range(1, 4)
    )
    return SimplicialOperators(probs, tuple(torch.ones_like(p) for p in probs), memberships)


@pytest.mark.parametrize("rows, fused_calls", [(4096, 1), (4095, 0)])
def test_layer_routes_by_min_fused_rows(rows, fused_calls, monkeypatch):
    """A rank of exactly MIN_FUSED_ROWS rows at C=8 takes the fused op; one
    row fewer does not. Both give the reference path's output."""
    assert port_combine.MIN_FUSED_ROWS == jax_combine.MIN_FUSED_ROWS == 4096
    sizes = (4, 6, 8, rows)
    ops = _stub_ops(sizes)
    rng = np.random.default_rng(6)
    feats = [torch.from_numpy(rng.standard_normal((1, s, LAYER_C)).astype(np.float32)) for s in sizes]
    seen = []
    real = port_sccn.fused_message_combine

    def spy(carriers, x, *rest):
        seen.append(tuple(x.shape))
        return real(carriers, x, *rest)

    monkeypatch.setattr(port_sccn, "fused_message_combine", spy)
    fused = port_sccn.GradientSCCNLayer(LAYER_C, is_final_layer=True, fused_combine=True)
    fused.reset_parameters(torch.Generator().manual_seed(0))
    plain = port_sccn.GradientSCCNLayer(LAYER_C, is_final_layer=True)
    plain.load_state_dict(fused.state_dict())
    with torch.no_grad():
        got, want = fused(feats, ops), plain(feats, ops)
    assert seen == [(1, rows, LAYER_C)] * fused_calls
    for g, w in zip(got, want):
        assert torch.equal(g, w)


# ------------------------------------------------ kernel_diag (rows 8-10)


@pytest.fixture(scope="module")
def kd():
    """benchmarks/kernel_diag.py, loaded as tests/test_ops.py loads it."""
    spec = importlib.util.spec_from_file_location(
        "_kernel_diag_under_test_torch",
        Path(__file__).resolve().parent.parent / "benchmarks" / "kernel_diag.py",
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _diag_inputs(kd, m, rows=256, seed=3):
    jx = kd.make_inputs(rows, m, 64, jnp.float32, seed=seed)
    return jx, [torch.from_numpy(np.array(a)) for a in jx]


def test_packed_plain_matches_kernel_diag(kd):
    """Row 8's plain version against packed_call, row 9's against
    packed_bwd_call, and autograd through packed_combine against
    make_packed_combine's gradients: all six cotangents."""
    jx, tx = _diag_inputs(kd, 2)
    want = np.asarray(kd.packed_call(*jx, tile=128, interpret=True))
    np.testing.assert_allclose(combine_diag.packed_combine_fwd(*tx).numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)
    np.testing.assert_allclose(combine_diag.packed_combine_plain(*tx).numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)

    dy = np.random.default_rng(4).standard_normal(want.shape).astype(np.float32)
    want_bwd = kd.packed_bwd_call(*jx, jnp.asarray(dy), tile=128, interpret=True)
    got_bwd = combine_diag.packed_combine_bwd(*tx, torch.from_numpy(dy))
    for name, g, w in zip(GRADS, got_bwd, want_bwd):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BWD_TOL, atol=BWD_TOL, err_msg=name)

    pc = kd.make_packed_combine(tile=128, interpret=True)
    want_grads = jax.grad(lambda *a: (pc(*a) ** 2).sum(), argnums=tuple(range(6)))(*jx)
    leaves = [t.clone().requires_grad_(True) for t in tx]
    got_grads = torch.autograd.grad((combine_diag.packed_combine(*leaves) ** 2).sum(), leaves)
    for name, g, w in zip(GRADS, got_grads, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BWD_TOL, atol=BWD_TOL, err_msg=name)
    assert combine_diag.packed_combine_fwd.launches == combine_diag.packed_combine_bwd.launches == 0


@pytest.mark.parametrize("variant", ["copy", "matmul", "nogelu"])
@pytest.mark.parametrize("m", [1, 3])
def test_ablation_plain_versions_match_kernel_diag(kd, variant, m):
    """Row 10: each ablation's plain version (and its wrapper on the CPU)
    against kernel_diag's kernel through _simple_call in interpret mode."""
    jx, tx = _diag_inputs(kd, m)
    car, x, v, w1, b1, w2 = jx
    c = x.shape[-1]
    kernel, extra = {
        "copy": (kd._copy_kernel, ()),
        "matmul": (kd._matmul_kernel, (v,)),
        "nogelu": (kd._nogelu_kernel, (v, w1, b1.reshape(1, c), w2.reshape(1, c))),
    }[variant]
    want = np.asarray(kd._simple_call(kernel, car, x, extra, 128, interpret=True))
    tcar, tx_, tv, tw1, tb1, tw2 = tx
    plain, wrapper = {
        "copy": (combine_diag.combine_copy_plain(tcar, tx_), combine_diag.combine_copy(tcar, tx_)),
        "matmul": (combine_diag.combine_matmul_plain(tcar, tx_, tv), combine_diag.combine_matmul(tcar, tx_, tv)),
        "nogelu": (combine_diag.combine_nogelu_plain(tcar, tx_, tv, tw1, tb1, tw2),
                   combine_diag.combine_nogelu(tcar, tx_, tv, tw1, tb1, tw2)),
    }[variant]
    assert torch.equal(plain, wrapper)
    np.testing.assert_allclose(plain.numpy(), want, rtol=FWD_TOL, atol=FWD_TOL)


def test_kernel_diag_writes_whole_tiles_only(kd):
    """A limit of the JAX harness, pinned: packed_call and _simple_call run
    p // tile grid steps, so a row count that is not a multiple of the tile
    leaves y's last rows unwritten (kernel_diag's main rounds P up first).
    The port's variants take any row count: the packed forward equals
    message_combine_reference on every row of 200, and packed_call on its
    whole 128-row tile."""
    jx, tx = _diag_inputs(kd, 2, rows=200)
    got = combine_diag.packed_combine_fwd(*tx).numpy()
    ref = np.asarray(kd.message_combine_reference(*jx))
    np.testing.assert_allclose(got, ref, rtol=FWD_TOL, atol=FWD_TOL)
    jax_y = np.asarray(kd.packed_call(*jx, tile=128, interpret=True))
    np.testing.assert_allclose(got[:128], jax_y[:128], rtol=FWD_TOL, atol=FWD_TOL)
    assert not np.allclose(jax_y[128:], ref[128:], atol=1e-3)  # rows 128-199 were never written
