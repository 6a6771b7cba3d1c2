"""PyTorch port vs the JAX package: the multiscale STFT (fft and matmul),
the spectral distance and its gradient, the autoencoder loss with its
invalid-sample penalty, InfoNCE and the triplet loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from topo_audio_autoencoder_torch.models.encoder import info_nce_loss as pt_info_nce
from topo_audio_autoencoder_torch.models.encoder import triplet_loss as pt_triplet
from topo_audio_autoencoder_torch.ops import stft as pt_stft
from topo_audio_autoencoder_torch.training import LossWeights as PtWeights
from topo_audio_autoencoder_torch.training import autoencoder_loss as pt_loss
from topo_audio_autoencoder_tpu.models.encoder import info_nce_loss, triplet_loss
from topo_audio_autoencoder_tpu.ops import stft as jax_stft
from topo_audio_autoencoder_tpu.training import LossWeights, autoencoder_loss

torch.set_num_threads(1)

T = 4096


def _signals(seed=0, batch=2, scale=1.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((batch, T))).astype(np.float32)


def test_frame_signal_matches_jax():
    x = _signals()[:, :1000]
    got = pt_stft.frame_signal(torch.from_numpy(x), 256, 64)
    want = jax_stft.frame_signal(jnp.asarray(x), 256, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# Magnitudes of unit-variance noise: fp32 FFTs / DFT matmuls in other
# orders, relative to the largest magnitude.
MAG_RTOL = 2e-6


@pytest.mark.parametrize("method", ["fft", "matmul", "hybrid"])
@pytest.mark.parametrize("n_fft", [2048, 128])
def test_stft_magnitude_matches_jax(method, n_fft):
    x = _signals()
    got = pt_stft.stft_magnitude(torch.from_numpy(x), n_fft, method=method)
    want = np.asarray(jax_stft.stft_magnitude(jnp.asarray(x), n_fft, method=method))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=MAG_RTOL * np.abs(want).max())


def test_stft_auto_is_fft_and_reflect_pad_needs_a_longer_signal():
    x = torch.from_numpy(_signals())
    torch.testing.assert_close(pt_stft.stft_magnitude(x, 512), pt_stft.stft_magnitude(x, 512, method="fft"))
    assert len(pt_stft.multiscale_stft(x)) == len(pt_stft.DEFAULT_SCALES)
    with pytest.raises(ValueError, match="reflect pad"):
        pt_stft.stft_magnitude(x[:, :1024], 2048)
    with pytest.raises(ValueError, match="method"):
        pt_stft.stft_magnitude(x, 512, method="bogus")


# Gradient tolerance relative to its largest element. Noise has a few bins
# of near-zero magnitude, whose log-term gradient 1/(|S| + 1e-7) points
# where the rounding of |S| points; the DFT as matmuls sums n_fft products
# per bin and rounds more than the FFT (measured 3.4e-4 against JAX). The
# hybrid method's backward is the DFT as matmuls too (measured 8.2e-5).
GRAD_RTOL = {"fft": 1e-4, "matmul": 1e-3, "hybrid": 1e-3}


@pytest.mark.parametrize("method", ["fft", "matmul", "hybrid"])
def test_spectral_distance_and_its_gradient_match_jax(method):
    """Two broadband signals: value within 1e-5 relative, gradient within
    GRAD_RTOL of its largest element."""
    x, y = _signals(1), _signals(2, scale=0.5)
    want = np.asarray(jax_stft.spectral_distance(jnp.asarray(x), jnp.asarray(y), method=method))
    want_g = np.asarray(jax.grad(
        lambda a: jax_stft.spectral_distance(a, jnp.asarray(y), method=method).sum()
    )(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = pt_stft.spectral_distance(xt, torch.from_numpy(y), method=method)
    got.sum().backward()
    assert got.shape == (2,)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=0, atol=GRAD_RTOL[method] * np.abs(want_g).max())


@pytest.mark.parametrize("valid", [(True, True), (True, False), (False, False)])
def test_autoencoder_loss_matches_jax(valid):
    rng = np.random.default_rng(3)
    recon, target = (rng.standard_normal((2, 1, T)).astype(np.float32) for _ in range(2))
    aux = {"binary_entropy": np.array([-0.1, -0.2], np.float32),
           "diversity": np.array([1.0, 3.0], np.float32), "l0": np.zeros(2, np.float32)}
    contrastive = np.float32(0.7)
    weights = dict(l0_penalty=0.5)
    want_total, want = autoencoder_loss(
        jnp.asarray(recon), jnp.asarray(target), {k: jnp.asarray(v) for k, v in aux.items()},
        jnp.asarray(valid), LossWeights(**weights), jnp.asarray(contrastive), with_per_sample=True,
    )
    got_total, got = pt_loss(
        torch.from_numpy(recon), torch.from_numpy(target), {k: torch.from_numpy(v) for k, v in aux.items()},
        torch.tensor(valid), PtWeights(**weights), torch.tensor(contrastive), with_per_sample=True,
    )
    assert set(got) == set(want)
    np.testing.assert_allclose(float(got_total), float(want_total), rtol=1e-5)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5, err_msg=k)
    if not any(valid):
        assert float(got_total) == pytest.approx(100.0 + 0.7)


def test_contrastive_losses_match_jax():
    logits = np.random.default_rng(4).standard_normal((3, 4, 50)).astype(np.float32)
    np.testing.assert_allclose(
        float(pt_info_nce(torch.from_numpy(logits))), float(info_nce_loss(jnp.asarray(logits))), rtol=1e-5)
    np.testing.assert_allclose(
        float(pt_info_nce(torch.from_numpy(logits), 0.5)), float(info_nce_loss(jnp.asarray(logits), 0.5)), rtol=1e-5)
    three = logits[:, :3]
    np.testing.assert_allclose(
        float(pt_triplet(torch.from_numpy(three))), float(triplet_loss(jnp.asarray(three))), rtol=1e-5)
    np.testing.assert_allclose(
        float(pt_triplet(torch.from_numpy(three), 20.0)), float(triplet_loss(jnp.asarray(three), 20.0)), rtol=1e-5)
