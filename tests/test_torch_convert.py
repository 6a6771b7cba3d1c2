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
