"""Shared set-up for the PyTorch port's parity tests (not a test module).

Both packages get the same parameters and the same inputs: a flax
parameter tree drawn with numpy from a seed (in the flax init families,
with non-trivial norm scales and biases so that every leaf matters) goes
to the JAX model as it is and to the port through ``convert.py``.
"""

from __future__ import annotations

import numpy as np

# The tiny config of tests/test_parity.py, with two SCCN layers so that a
# non-final layer (which owns norm parameters) and the final one both run.
TINY = dict(num_vertices=5, num_bands=4, sccn_hidden_dim=8, n_sccn_layers=2)
T = 1024

_SCALARS = {"skip_weight": 0.1, "vertex_bias": 2.0, "attention_scale": 0.5}
# The learned Hard Concrete stretch: softplus^-1 of its init (beta 2/3,
# -gamma 0.1, zeta - 1 0.1), moved by 0.2 standard normals so that the
# learned stretch differs from the fixed one, per rank.
_HC_RAW = {"hc_beta_raw": 2.0 / 3.0, "hc_gamma_raw": 0.1, "hc_zeta_raw": 0.1}


def _leaf(rng, path, shape):
    name = path[-1]
    if name in _SCALARS:
        return np.full(shape, _SCALARS[name], np.float32)
    if name in _HC_RAW:
        raw = np.log(np.expm1(_HC_RAW[name]))
        return (raw + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    if name.startswith("embed_rank"):
        return rng.standard_normal(shape).astype(np.float32)
    if name == "scale" or name.startswith("scale_"):
        return (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    if name == "bias" or name.startswith("attn_b1_"):
        return (0.1 * rng.standard_normal(shape)).astype(np.float32)
    # Dense/Conv kernels and the SCCN's raw matrices: variance 1/fan_in.
    fan_in = int(np.prod(shape[:-1]))
    return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)


# Seed and logit shift of the parity model. The shift is added to the last
# encoder bias so that most logits clear the 0.5 threshold and the latent
# holds edges, triangles and tetrahedra (the seed's two clips activate
# 10/18/11/2 simplices), and every rank's products and the attention
# memory carry real data.
SEED = 1
LOGIT_SHIFT = 1.0
WAVE_SEED = 11  # waveforms(WAVE_SEED, 2): the parity clips


def flax_params(jax_model, seed: int = SEED, num_samples: int = T,
                logit_shift: float = LOGIT_SHIFT) -> dict:
    """{"params": nested dicts of numpy arrays} in the JAX model's layout."""
    import jax
    import jax.numpy as jnp

    shapes = jax.eval_shape(
        lambda: jax_model.init(
            {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
            jnp.zeros((1, 1, num_samples)), 1.0, jax.random.PRNGKey(2), True,
        )
    )
    params = random_tree(shapes, seed)
    params["params"]["encoder"]["mlp2"]["bias"] += np.float32(logit_shift)
    return params


def random_tree(shapes: dict, seed: int) -> dict:
    """A tree of numpy leaves shaped like ``shapes`` (nested dicts of arrays
    or shape structs), each drawn from its family by name."""
    rng = np.random.default_rng(seed)

    def fill(tree, path=()):
        return {
            k: fill(v, (*path, k)) if isinstance(v, dict) else _leaf(rng, (*path, k), v.shape)
            for k, v in sorted(tree.items())
        }

    return fill(shapes)


def port_model(params: dict, num_samples: int = T, **options):
    """The port's tiny model on the CPU, loaded with the converted tree.
    ``options`` go to ``AudioAutoencoder.create`` (e.g. ``dropout``)."""
    from topo_audio_autoencoder_torch.convert import state_dict_from_flax
    from topo_audio_autoencoder_torch.models import AudioAutoencoder

    model = AudioAutoencoder.create(**TINY, num_samples=num_samples, device="cpu", **options)
    model.load_state_dict(state_dict_from_flax(params, model.state_dict()))
    return model


def margin_mask(logits: np.ndarray, num_vertices: int, margin: float) -> np.ndarray:
    """True where the biased logit clears the 0.5 threshold by ``margin``:
    there a 1e-6 difference between the packages cannot flip the bit."""
    biased = logits.copy()
    biased[..., :num_vertices] += 2.0  # relu(vertex_bias) of the parity params
    return np.abs(biased - 0.5) > margin


def waveforms(seed: int, batch: int, num_samples: int = T) -> np.ndarray:
    """[B, 1, T] float32: a few sines plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(num_samples) / 16000.0
    freqs = rng.uniform(80.0, 4000.0, size=(batch, 3, 1))
    amps = rng.uniform(0.1, 0.5, size=(batch, 3, 1))
    x = (amps * np.sin(2 * np.pi * freqs * t)).sum(axis=1)
    x += 0.05 * rng.standard_normal((batch, num_samples))
    return x[:, None, :].astype(np.float32)


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def hc_preclip(biased: np.ndarray, u, beta=2.0 / 3.0, gamma=-0.1, zeta=1.1) -> np.ndarray:
    """The Hard Concrete gates before the clip, in float64: train mode with
    uniforms ``u``, eval mode (the noiseless gate) with ``u`` None."""
    a = biased.astype(np.float64)
    if u is None:
        s = _sigmoid(a)
    else:
        u = np.asarray(u, np.float64)
        s = _sigmoid((np.log(u) - np.log1p(-u) + a) / beta)
    return s * (zeta - gamma) + gamma


def clip_margin(pre: np.ndarray) -> float:
    """The smallest distance of a pre-clip gate from 0 and from 1. A gate
    closer than the packages' rounding difference may clip on one side and
    not on the other, and flip an attention mask bit."""
    return float(min(np.abs(pre).min(), np.abs(pre - 1.0).min()))


def draw_margin(u_ranks, p_ranks) -> float:
    """The smallest distance of a uniform from the probability it is
    compared with (a Bernoulli draw ``u < p``, or a threshold)."""
    return float(min(np.abs(np.asarray(u, np.float64) - np.asarray(p, np.float64)).min()
                     for u, p in zip(u_ranks, p_ranks)))


def jax_hard_noise(key, rect_shapes) -> list:
    """The uniforms ``jax.random.bernoulli`` draws for the four ranks from
    the encoder's ``hard_rng`` (bernoulli(k, p) is uniform(k) < p)."""
    import jax

    keys = jax.random.split(key, 4)
    return [np.array(jax.random.uniform(k, shape, np.float32)) for k, shape in zip(keys, rect_shapes)]
