"""convert.py: the flax parameter tree -> the port's state_dict."""

import copy

import numpy as np
import pytest
import torch
from _torch_parity import TINY, flax_params

from topo_audio_autoencoder_torch.convert import state_dict_from_flax
from topo_audio_autoencoder_torch.models import AudioAutoencoder as TorchAutoencoder
from topo_audio_autoencoder_tpu.models import AudioAutoencoder as JaxAutoencoder

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def trees():
    params = flax_params(JaxAutoencoder.create(**TINY))
    model = TorchAutoencoder.create(**TINY, num_samples=1024, device="cpu")
    return params, model


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, (*path, k))
        else:
            yield (*path, k), v


def _back_to_flax(name: str, value: torch.Tensor, flax_leaf: np.ndarray) -> np.ndarray:
    """Undo the layout change of one converted leaf."""
    a = value.numpy()
    if name.endswith(".weight") and a.ndim == 2 and flax_leaf.ndim == 2:
        return a.T
    if name.endswith(".weight") and a.ndim == 3:
        return a.transpose(2, 1, 0)
    return a


def test_round_trip_consumes_every_leaf_and_fills_every_parameter(trees):
    params, model = trees
    template = model.state_dict()
    sd = state_dict_from_flax(params, template)
    assert sd.keys() == template.keys()
    model.load_state_dict(sd, strict=True)
    leaves = dict(_leaves(params["params"]))
    assert len(leaves) == len(sd)
    by_name = {}
    for path, leaf in leaves.items():
        *mods, last = path
        name = ".".join((*mods, "weight" if last in ("kernel", "scale") else last))
        by_name[name] = leaf
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(
            _back_to_flax(name, value, by_name[name]), by_name[name], err_msg=name
        )
    # The outer {"params": ...} is optional.
    sd2 = state_dict_from_flax(params["params"], template)
    assert all(torch.equal(sd[k], sd2[k]) for k in sd)


def test_wrong_shape_leaf_raises(trees):
    params, model = trees
    bad = copy.deepcopy(params)
    bad["params"]["decoder"]["cross_attention"]["q_proj"]["kernel"] = np.zeros((8, 9), np.float32)
    with pytest.raises(ValueError, match="q_proj.weight"):
        state_dict_from_flax(bad, model.state_dict())


def test_unconsumed_leaf_raises(trees):
    params, model = trees
    bad = copy.deepcopy(params)
    bad["params"]["decoder"]["hc_beta_raw"] = np.zeros(4, np.float32)
    with pytest.raises(KeyError, match="hc_beta_raw"):
        state_dict_from_flax(bad, model.state_dict())


def test_unfilled_parameter_raises(trees):
    params, model = trees
    bad = copy.deepcopy(params)
    del bad["params"]["encoder"]["embed_norm2"]
    with pytest.raises(KeyError, match="embed_norm2"):
        state_dict_from_flax(bad, model.state_dict())


def test_a_jax_train_state_converts():
    """The parameters of a JAX TrainState (create_train_state) load into a
    port model of the same geometry; optimizer state starts fresh."""
    import jax

    from topo_audio_autoencoder_tpu.training import create_train_state, make_optimizer

    jm = JaxAutoencoder.create(**TINY)
    state = create_train_state(jm, make_optimizer(), jax.random.PRNGKey(0), (1, 1, 1024))
    params = jax.tree.map(np.asarray, state.params)
    model = TorchAutoencoder.create(**TINY, num_samples=1024, device="cpu")
    sd = state_dict_from_flax(params, model.state_dict())
    model.load_state_dict(sd, strict=True)
    assert sd["encoder.skip_weight"].shape == ()  # scalars keep their shape
    np.testing.assert_array_equal(
        model.encoder.mlp0.weight.detach().numpy(), params["params"]["encoder"]["mlp0"]["kernel"].T
    )


def test_a_learned_hc_tree_converts():
    """The learned stretch's [4] leaves (hc_beta_raw, hc_gamma_raw,
    hc_zeta_raw) map by name, unchanged."""
    options = dict(sampler="hard_concrete", learned_hc=True)
    params = flax_params(JaxAutoencoder.create(**TINY, **options))
    model = TorchAutoencoder.create(**TINY, num_samples=1024, device="cpu", **options)
    sd = state_dict_from_flax(params, model.state_dict())
    model.load_state_dict(sd, strict=True)
    assert len(sd) == len(dict(_leaves(params["params"])))
    for name in ("hc_beta_raw", "hc_gamma_raw", "hc_zeta_raw"):
        leaf = params["params"]["encoder"][name]
        assert leaf.shape == (4,)
        np.testing.assert_array_equal(getattr(model.encoder, name).detach().numpy(), leaf)
    # A fixed-stretch model has no such parameters: the leaves are refused.
    fixed = TorchAutoencoder.create(**TINY, num_samples=1024, device="cpu", sampler="hard_concrete")
    with pytest.raises(KeyError, match="hc_"):
        state_dict_from_flax(params, fixed.state_dict())


# ------------------------------------------------------------ optimizer state

# tests/test_trainer.py's model; the JAX step runs at 1,024 samples, B=1, G=1.
SMALL = dict(num_vertices=4, num_bands=4, sccn_hidden_dim=8, n_sccn_layers=1)
OPT_RTOL = 1e-6


@pytest.fixture(scope="module")
def optax_run():
    """Gradients recorded from JAX's own train step (an optimizer that keeps
    the gradient it is given, as tests/test_torch_training.py records
    them), and the JAX optimizer (accumulation 2) over them: its state
    after 3 micro-steps and after a 4th."""
    import jax
    import jax.numpy as jnp
    import optax

    from topo_audio_autoencoder_tpu.training import TrainState, make_optimizer, make_train_step

    def record():
        return optax.GradientTransformation(
            lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
            lambda u, s, p=None: (jax.tree.map(jnp.zeros_like, u), {"g": u}),
        )

    jm = JaxAutoencoder.create(**SMALL)
    params = jax.tree.map(jnp.asarray, flax_params(jm, num_samples=1024))
    rec = record()
    step = make_train_step(jm, rec, donate=False)
    opt = make_optimizer(accumulate_grad_batches=2)
    opt_update = jax.jit(opt.update)
    opt_state = opt.init(params)
    rng = np.random.default_rng(7)
    host = jax.device_get
    out = {"params": [host(params)], "grads": [], "states": []}
    for i in range(4):
        batch = jnp.asarray(0.3 * rng.standard_normal((1, 1, 1, 1024)).astype(np.float32))
        new, _ = step(TrainState(params, rec.init(params), jnp.int32(i)), batch, 1.0, jax.random.PRNGKey(3))
        grads = new.opt_state["g"]
        updates, opt_state = opt_update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        out["grads"].append(host(grads))
        out["states"].append(host(opt_state))
        out["params"].append(host(params))
    return out


def _close(got: torch.Tensor, want: torch.Tensor, what: str) -> None:
    """Equal to OPT_RTOL of the leaf's largest element."""
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= OPT_RTOL * scale, what


def test_optax_state_converts_and_the_next_update_agrees(optax_run):
    """The JAX optax state after 3 micro-steps (one applied update, one
    gradient accumulated) converts to the port's OptState; one more
    micro-step (an applied update) on both sides agrees: mu, nu, count,
    mini_step, acc and the parameters, each leaf to 1e-6 of its largest
    element."""
    from topo_audio_autoencoder_torch.convert import opt_state_from_optax
    from topo_audio_autoencoder_torch.training import make_optimizer

    model = TorchAutoencoder.create(**SMALL, num_samples=1024, device="cpu")
    template = model.state_dict()
    state = opt_state_from_optax(optax_run["states"][2], template)
    assert (state.count, state.mini_step) == (1, 1)
    assert state.mu.keys() == state.nu.keys() == state.acc.keys() == template.keys()
    want_acc = state_dict_from_flax(optax_run["grads"][2], template)  # the cycle's first gradient
    for n in template:
        _close(state.acc[n], want_acc[n], f"acc {n}")

    model.load_state_dict(state_dict_from_flax(optax_run["params"][3], template))
    applied = make_optimizer(accumulate_grad_batches=2).update(
        state_dict_from_flax(optax_run["grads"][3], template), state, model)
    assert applied
    want = opt_state_from_optax(optax_run["states"][3], template)
    assert (state.count, state.mini_step, state.acc) == (want.count, want.mini_step, want.acc) == (2, 0, {})
    want_params = state_dict_from_flax(optax_run["params"][4], template)
    for n, p in model.named_parameters():
        _close(state.mu[n], want.mu[n], f"mu {n}")
        _close(state.nu[n], want.nu[n], f"nu {n}")
        _close(p.detach(), want_params[n], f"param {n}")
    # Without accumulation the state has no MultiSteps wrapper.
    flat = opt_state_from_optax(optax_run["states"][3].inner_opt_state, template)
    assert (flat.count, flat.mini_step, flat.acc) == (2, 0, {})


def _with_encoder_mu(state, edit):
    """``state`` with the encoder group's mu tree replaced by ``edit(mu)``."""
    part = state.inner_opt_state[1]
    enc = part.inner_states["encoder"]
    adam = enc.inner_state[0]
    mu = edit(copy.deepcopy(adam.mu))
    enc = enc._replace(inner_state=(adam._replace(mu=mu), *enc.inner_state[1:]))
    part = part._replace(inner_states={**part.inner_states, "encoder": enc})
    return state._replace(inner_opt_state=(state.inner_opt_state[0], part))


def test_optax_state_refuses_a_leaf_it_cannot_place(optax_run):
    from topo_audio_autoencoder_torch.convert import opt_state_from_optax

    template = TorchAutoencoder.create(**SMALL, num_samples=1024, device="cpu").state_dict()
    state = optax_run["states"][2]

    def foreign(mu):
        mu["params"]["encoder"]["bogus"] = np.zeros(3, np.float32)
        return mu

    def wrong_group(mu):
        mu["params"]["decoder"]["cross_attention"]["q_proj"]["kernel"] = np.zeros((8, 8), np.float32)
        return mu

    def missing(mu):
        del mu["params"]["encoder"]["mlp0"]
        return mu

    with pytest.raises(KeyError, match="bogus"):
        opt_state_from_optax(_with_encoder_mu(state, foreign), template)
    with pytest.raises(ValueError, match="q_proj"):
        opt_state_from_optax(_with_encoder_mu(state, wrong_group), template)
    with pytest.raises(KeyError, match="mlp0"):
        opt_state_from_optax(_with_encoder_mu(state, missing), template)
