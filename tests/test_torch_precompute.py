"""PyTorch port vs the JAX package: the hybrid STFT (rfft forward, DFT
matmul backward), the pairwise distance block, the tiled distance matrix,
the neighbor ordering and the ``.npz`` both packages read. On the CPU, at
T = 2048 with scales (512, 256), N = 12 and tile 5 (as tests/test_data.py),
so the last tile is padded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch import data as pt
from topo_audio_autoencoder_torch.ops import stft as pt_stft
from topo_audio_autoencoder_tpu import data as jx
from topo_audio_autoencoder_tpu.ops import stft as jax_stft

torch.set_num_threads(1)

N, T = 12, 2048
SCALES = (512, 256)
# Distances against JAX's: the same formula, fp32 FFTs, products and sums
# in other orders; relative to the largest entry (measured 4.5e-7).
DIST_RTOL = 1e-5


@pytest.fixture(scope="module")
def corpus():
    return pt.synth_corpus(N, n_samples=T, seed=0)


@pytest.fixture(scope="module")
def matrices(corpus):
    got = pt.compute_distance_matrix(corpus, tile=5, scales=SCALES, device="cpu")
    want = jx.compute_distance_matrix(corpus, tile=5, scales=SCALES)
    return got, want


@pytest.mark.parametrize("n_fft", [2048, 256])
def test_hybrid_stft_value_and_vjp_match_jax(n_fft):
    """The hybrid magnitude and its custom backward against JAX's
    _mag_hybrid through jax.vjp, on one random cotangent: value within
    2e-6 and gradient within 1e-5 of their largest elements (measured
    1.8e-7 and 7.4e-7)."""
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal((2, 4096)).astype(np.float32)
    want, vjp = jax.vjp(lambda a: jax_stft.stft_magnitude(a, n_fft, method="hybrid"), jnp.asarray(x))
    ct = rng.standard_normal(want.shape).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(ct))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pt_stft.stft_magnitude(xt, n_fft, method="hybrid")
    assert type(got.grad_fn).__name__ == "_MagHybridBackward"
    got.backward(torch.from_numpy(ct))
    want, want_g = np.asarray(want), np.asarray(want_g)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=2e-6 * np.abs(want).max())
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=0, atol=1e-5 * np.abs(want_g).max())
    fft = pt_stft.stft_magnitude(torch.from_numpy(x), n_fft, method="fft")
    np.testing.assert_allclose(got.detach().numpy(), fft.numpy(), rtol=0, atol=2e-6 * np.abs(want).max())


@pytest.mark.parametrize("t, scales", [(T, SCALES), (8192, (512,))])
def test_distance_block_matches_jax(corpus, t, scales):
    """[A, B] blocks against JAX's, within DIST_RTOL of the largest entry.
    At T = 8192 the 512-point scale flattens to 65 x 257 = 16,705 bins:
    three log-term chunks of 8,192, the last zero-padded."""
    xs = corpus if t == T else pt.synth_corpus(7, n_samples=t, seed=3)
    a, b = xs[:4], xs[4:]
    got = pt_stft.spectral_distance_matrix_block(torch.from_numpy(a), torch.from_numpy(b), scales).numpy()
    want = np.asarray(jax_stft.spectral_distance_matrix_block(jnp.asarray(a), jnp.asarray(b), scales))
    assert got.shape == (4, len(b))
    np.testing.assert_allclose(got, want, rtol=0, atol=DIST_RTOL * np.abs(want).max())


def test_distance_matrix_matches_jax_and_direct_distances(corpus, matrices):
    """The tiled matrix with a padded last tile (N = 12, tile 5) against
    JAX's within DIST_RTOL of the largest entry; zero diagonal, exactly
    symmetric, and d(i, j) for i < j equal to the port's spectral_distance
    within rtol 1e-3, atol 1e-4 (tests/test_data.py's bound)."""
    got, want = matrices
    assert got.shape == (N, N) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=DIST_RTOL * np.abs(want).max())
    np.testing.assert_array_equal(np.diag(got), 0.0)
    np.testing.assert_array_equal(got, got.T)
    for i, j in [(0, 1), (3, 7), (2, 11), (9, 10)]:
        d = pt_stft.spectral_distance(torch.from_numpy(corpus[i])[None], torch.from_numpy(corpus[j])[None], SCALES)
        np.testing.assert_allclose(got[i, j], float(d[0]), rtol=1e-3, atol=1e-4)
    unpadded = pt.compute_distance_matrix(corpus, tile=N, scales=SCALES, device="cpu")
    np.testing.assert_allclose(got, unpadded, rtol=0, atol=DIST_RTOL * np.abs(want).max())


def test_sort_neighbors_under_the_margin_rule(matrices):
    """Neighbor orderings from each package's own matrix. The two matrices
    differ in the last bits, so near-ties could swap: first the margin
    (every gap between adjacent sorted distances of a row exceeds twice
    the largest difference between the matrices), then equal orderings."""
    got, want = matrices
    diff = float(np.abs(got - want).max())
    nb = jx.sort_neighbors(want)
    gaps = np.diff(np.take_along_axis(want, nb.astype(np.int64), axis=1), axis=1)
    assert gaps.min() > 2 * diff, f"margin {gaps.min()} not above 2 x {diff}"
    np.testing.assert_array_equal(pt.sort_neighbors(got), nb)


def test_sort_neighbors_matches_jax_on_ties():
    """On one matrix, ties included (a zero off the diagonal, equal
    entries), the port's vectorized removal of self equals JAX's loop."""
    d = np.array(
        [[0.0, 2.0, 1.0, 1.0], [0.0, 0.0, 3.0, 0.0], [1.0, 3.0, 0.0, 2.0], [5.0, 5.0, 5.0, 5.0]], np.float32
    )
    got = pt.sort_neighbors(d)
    assert got.dtype == np.int32 and got.shape == (4, 3)
    np.testing.assert_array_equal(got, jx.sort_neighbors(d))
    np.testing.assert_array_equal(got[1], [0, 3, 2])
    np.testing.assert_array_equal(got[3], [0, 1, 2])


def test_npz_is_interchangeable_between_the_packages(tmp_path, corpus):
    """compute_distances' .npz written by either package loads in the
    other, with the same keys and arrays."""
    got = pt.compute_distances(corpus, save_path=tmp_path / "pt" / "d.npz", tile=6, scales=SCALES, device="cpu")
    want = jx.compute_distances(corpus, save_path=tmp_path / "jx" / "d.npz", tile=6, scales=SCALES)
    for path, result in ((tmp_path / "pt" / "d.npz", got), (tmp_path / "jx" / "d.npz", want)):
        for loaded in (jx.load_distances(path), pt.load_distances(path)):
            assert set(loaded) == {"distances", "neighbors"}
            for k in loaded:
                assert loaded[k].dtype == result[k].dtype
                np.testing.assert_array_equal(loaded[k], result[k])
    np.testing.assert_array_equal(got["neighbors"], pt.sort_neighbors(got["distances"]))


def test_precompute_defaults_to_the_card(corpus):
    """With no device and no card the precompute raises rather than
    running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would use it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.compute_distance_matrix(corpus[:3], tile=2, scales=SCALES)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.compute_distances(corpus[:3], tile=2, scales=SCALES)
