"""The CUDA combine kernels' row split and cross-block sum, mirrored in torch
on the CPU.

``combine_row_ranges`` gives the contiguous ranges of 32-row units that the
kernels' blocks own; ``combine_bwd_blocked_plain`` computes the backward's
weight gradients range by range in fp32 and sums them in block order, as
the backward kernel's second pass does. Both are held here against the
plain backward and the JAX package's ``_bwd_call`` in interpret mode on the
same numpy inputs.
"""

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch.ops import sccn_combine as port_combine
from topo_audio_autoencoder_tpu.ops import sccn_combine as jax_combine

torch.set_num_threads(1)

# fp32 on every side, the same operations in other summation orders: the
# tolerance of tests/test_torch_combine.py (the JAX package's own).
BWD_TOL = 2e-4
UNIT = port_combine.ROW_UNIT
ROWS = [1, 31, 32, 33, 64, 65, 4097, 18240, 77520]
# 132 and 264: the backward's and the forward's grid on an H100; None: more
# blocks than 32-row units.
BLOCKS = [1, 2, 7, 132, 264, None]


@pytest.mark.parametrize("blocks", BLOCKS, ids=lambda b: "more_than_units" if b is None else f"{b}blocks")
@pytest.mark.parametrize("rows", ROWS, ids=lambda r: f"{r}rows")
def test_row_ranges_cover_every_row_once_in_order(rows, blocks):
    units = -(-rows // UNIT)
    blocks = units + 3 if blocks is None else blocks
    ranges = port_combine.combine_row_ranges(rows, blocks)
    assert len(ranges) == blocks
    assert ranges[0][0] == 0 and ranges[-1][1] == rows
    for (_, end), (start, _) in zip(ranges, ranges[1:]):
        assert start == end  # contiguous, in block order: each row once
    assert all(start <= end for start, end in ranges)
    assert all(end % UNIT == 0 for _, end in ranges[:-1])
    sizes = [end - start for start, end in ranges]
    assert max(sizes) - min(sizes) <= UNIT
    if blocks > units:
        assert min(sizes) == 0


def _inputs(m, rows, c=16, seed=0):
    rng = np.random.default_rng(seed + 10 * m + rows)
    car = rng.standard_normal((m, rows, c)).astype(np.float32)
    x = rng.standard_normal((rows, c)).astype(np.float32)
    v = (rng.standard_normal((m, c, c)) * 0.3).astype(np.float32)
    w1 = (rng.standard_normal((c, c)) * 0.3).astype(np.float32)
    b1 = (rng.standard_normal((c,)) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((c, 1)) * 0.3).astype(np.float32)
    dy = rng.standard_normal((rows, c)).astype(np.float32)
    return car, x, v, w1, b1, w2, dy


@lru_cache(maxsize=None)
def _jax_weight_grads(m, rows):
    """dV, dW1, db1, dw2 of _bwd_call in interpret mode on JAX's row-padded layout."""
    car, x, v, w1, b1, w2, dy = _inputs(m, rows)
    c = x.shape[-1]
    car2, x2 = jax_combine._flatten_pad(jnp.asarray(car)[:, None], jnp.asarray(x)[None])
    dy2 = jnp.pad(jnp.asarray(dy), ((0, car2.shape[1] - rows), (0, 0)))
    args = (car2, x2, jnp.asarray(v), jnp.asarray(w1), jnp.asarray(b1), jnp.asarray(w2), dy2)
    _, _, dv, dw1, db1, dw2 = jax_combine._bwd_call(*args, interpret=True)
    return np.asarray(dv), np.asarray(dw1), np.asarray(db1).reshape(c), np.asarray(dw2).reshape(c, 1)


@pytest.mark.parametrize("blocks", [1, 3, 132])
@pytest.mark.parametrize("rows", [74, 4097])
@pytest.mark.parametrize("m", [1, 2, 3])
def test_blocked_backward_matches_plain_and_jax(m, rows, blocks):
    car, x, v, w1, b1, w2, dy = (torch.from_numpy(a) for a in _inputs(m, rows))
    args = (tuple(car), x, v, w1, b1, w2, dy)
    got = port_combine.combine_bwd_blocked_plain(*args, blocks)
    want = port_combine.combine_bwd_plain(*args)
    for g, w in zip((*got[0], got[1]), (*want[0], want[1])):
        assert torch.equal(g, w)  # dcarriers and dx per row, as the plain backward
    names = ("dv", "dw1", "db1", "dw2")
    for name, g, w, j in zip(names, got[2:], want[2:], _jax_weight_grads(m, rows)):
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        if blocks == 1:
            assert torch.equal(g, w), name  # one range: the plain backward itself
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=BWD_TOL, atol=BWD_TOL, err_msg=name)
        np.testing.assert_allclose(g.numpy(), j, rtol=BWD_TOL, atol=BWD_TOL, err_msg=name)
