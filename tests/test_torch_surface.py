"""The port's public surface against the JAX package's: every name a JAX
subpackage exports, every public name a JAX module defines, and every
parameter of its public functions and methods exist in the port, but for
the exceptions listed here with their reasons; and the names added to
complete it behave as the JAX ones do."""

import importlib
import inspect
import pkgutil

import numpy as np
import pytest
import torch

import topo_audio_autoencoder_tpu as jax_pkg

torch.set_num_threads(1)

JAX, PORT = "topo_audio_autoencoder_tpu", "topo_audio_autoencoder_torch"
SUBPACKAGES = ("data", "models", "ops", "parallel", "topology", "training", "utils")
# JAX module -> the port modules that hold its names.
COUNTERPARTS = {"ops.pallas_kernels": ("ops.fused_samplers", "ops.fused_hard_concrete")}

# Names the port does not carry, and why.
NAME_EXCEPTIONS = {
    "batch_sharding": "a jax.sharding.NamedSharding over the mesh: torch has no sharding object; the port's "
                      "ranks each hold their rows (parallel.shard_batch)",
    "replicated": "a NamedSharding, as batch_sharding; the port broadcasts from rank 0 (parallel.replicate)",
}
# Methods of a JAX class the port's class does not carry, and why.
METHOD_EXCEPTIONS = {
    "setup": "flax's deferred constructor: the port builds its submodules in __init__",
    "jit_init": "flax's compiled init of a parameter tree: the port's create() builds seeded weights",
    "reset_params": "returns a fresh flax tree; the port's module holds its weights and reseeds them in place "
                    "(reset_parameters)",
}
# Parameters of a JAX function the port's counterpart does not take, and why.
PARAM_EXCEPTIONS = {
    "key": "a JAX PRNG key: the port takes a torch.Generator (generator) where it draws",
    "rng": "a JAX PRNG key, as key",
    "donate": "buffer donation to jit: the port's step updates its state in place",
    "axis": "the mesh axis name: the port's mesh is one process group with one axis",
    "sample_shape": "a sample that flax traces to infer shapes: the port's shapes are fixed at create",
    "params": "the flax parameter tree: a torch module holds its own parameters",
    "interpret": "Pallas's interpret mode: a port wrapper runs the plain version on CPU tensors",
}
# A flax module's __call__ is the port module's forward.
CALL = {"__call__": "forward"}


def _jax_modules() -> list:
    names = ["codec_cli", "config", "inference", "main"]
    for sub in SUBPACKAGES:
        names.append(sub)
        pkg = importlib.import_module(f"{JAX}.{sub}")
        names += [f"{sub}.{m.name}" for m in pkgutil.iter_modules(pkg.__path__)]
    return names


def _public_names(module_name: str) -> list:
    """A subpackage's ``__all__``; a module's public names defined in it."""
    module = importlib.import_module(f"{JAX}.{module_name}")
    if module_name in SUBPACKAGES:
        return list(module.__all__)
    return sorted(n for n, v in vars(module).items()
                  if not n.startswith("_") and getattr(v, "__module__", None) == module.__name__)


def _port_lookup(module_name: str, name: str):
    for counterpart in COUNTERPARTS.get(module_name, (module_name,)):
        module = importlib.import_module(f"{PORT}.{counterpart}")
        if hasattr(module, name):
            return getattr(module, name)
    return None


def _missing_params(jax_fn, port_fn) -> list:
    try:
        want = inspect.signature(jax_fn).parameters
        have = inspect.signature(port_fn).parameters
    except (TypeError, ValueError):  # a builtin or a class without a Python signature
        return []
    return [p for p in want if p not in have and p not in ("self", "cls") and p not in PARAM_EXCEPTIONS]


def _gaps(module_name: str) -> list:
    gaps = []
    for name in _public_names(module_name):
        port = _port_lookup(module_name, name)
        if port is None:
            if name not in NAME_EXCEPTIONS:
                gaps.append(f"{module_name}.{name}: missing")
            continue
        jax_value = getattr(importlib.import_module(f"{JAX}.{module_name}"), name)
        if inspect.isfunction(jax_value):
            gaps += [f"{module_name}.{name}({p})" for p in _missing_params(jax_value, port)]
        elif inspect.isclass(jax_value) and module_name not in SUBPACKAGES:
            for attr, raw in vars(jax_value).items():
                if attr.startswith("_") and attr not in CALL:
                    continue
                if not isinstance(raw, (classmethod, staticmethod)) and not inspect.isfunction(raw):
                    continue
                port_attr = CALL.get(attr, attr)
                if not hasattr(port, port_attr):
                    if attr not in METHOD_EXCEPTIONS:
                        gaps.append(f"{module_name}.{name}.{attr}: missing")
                    continue
                gaps += [f"{module_name}.{name}.{attr}({p})"
                         for p in _missing_params(getattr(jax_value, attr), getattr(port, port_attr))]
    return gaps


@pytest.mark.parametrize("module_name", _jax_modules())
def test_every_public_jax_name_and_parameter_is_in_the_port(module_name):
    assert _gaps(module_name) == []


def test_the_exceptions_are_still_needed():
    """Each listed exception names something the JAX package has and the
    port lacks: one that the port gains, or JAX drops, must leave the list."""
    jax_names = {n for m in _jax_modules() for n in _public_names(m)}
    for name in NAME_EXCEPTIONS:
        assert name in jax_names
        assert all(_port_lookup(m, name) is None for m in SUBPACKAGES), name


def test_the_package_imports_topology_and_ops_as_jaxs_does():
    import topo_audio_autoencoder_torch as port

    assert jax_pkg.topology and jax_pkg.ops
    assert port.topology.__name__ == f"{PORT}.topology" and port.ops.__name__ == f"{PORT}.ops"


def test_hard_concrete_fused_wrappers_match_the_samplers():
    """``hard_concrete_fused`` and ``hard_concrete_fused_learned`` on the
    CPU: train mode is the fused pass's plain version on the generator's
    Philox seed, bit for bit; eval mode the noiseless gate, as JAX's at
    1e-6."""
    from topo_audio_autoencoder_torch.ops import HardConcreteParams, fused_hard_concrete as hc
    from topo_audio_autoencoder_torch.ops.fused_samplers import seed_from
    from topo_audio_autoencoder_tpu.ops import pallas_kernels as jk
    from topo_audio_autoencoder_tpu.ops import samplers as js

    rng = np.random.default_rng(0)
    logits = torch.from_numpy(rng.standard_normal((3, 40)).astype(np.float32))
    rows = [torch.from_numpy(v.astype(np.float32)) for v in
            (rng.uniform(0.5, 1.0, 40), rng.uniform(-0.2, -0.05, 40), rng.uniform(1.05, 1.2, 40))]
    params = HardConcreteParams(-0.15, 1.05)
    got = hc.hard_concrete_fused(logits, torch.Generator().manual_seed(4), 0.7, params)
    want = hc.hard_concrete_sample(logits, 0.7, seed=seed_from(torch.Generator().manual_seed(4)),
                                   gamma=-0.15, zeta=1.05)
    assert torch.equal(got, want)
    got = hc.hard_concrete_fused_learned(logits, torch.Generator().manual_seed(4), *rows)
    want = hc.hard_concrete_learned_sample(logits, *rows, seed=seed_from(torch.Generator().manual_seed(4)))
    assert torch.equal(got, want)
    import jax.numpy as jnp

    evals = (  # eval mode draws nothing: no key
        (hc.hard_concrete_fused(logits, None, 0.7, params, training=False),
         jk.hard_concrete_fused(jnp.asarray(logits.numpy()), None, 0.7, js.HardConcreteParams(-0.15, 1.05),
                                training=False)),
        (hc.hard_concrete_fused_learned(logits, None, *rows, training=False),
         jk.hard_concrete_fused_learned(jnp.asarray(logits.numpy()), None, *(jnp.asarray(r.numpy()) for r in rows),
                                        training=False)),
    )
    for got, want in evals:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_pqmf_create_and_native_available(monkeypatch):
    """``PQMF.create`` is the constructor, with JAX's filters;
    ``native_available`` reports the native library without raising."""
    from topo_audio_autoencoder_torch.data import native_loader
    from topo_audio_autoencoder_torch.ops import PQMF
    from topo_audio_autoencoder_tpu.ops import PQMF as JaxPQMF

    made, built = PQMF.create(80.0, 8), PQMF(80.0, 8)
    assert torch.equal(made.filters, built.filters) and made.n_band == 8
    np.testing.assert_allclose(made.filters[:, 0].numpy(), np.asarray(JaxPQMF.create(80.0, 8).filters),
                               rtol=0, atol=1e-7)
    assert native_loader.native_available()

    def fail():
        raise RuntimeError("native audio runtime build failed")

    monkeypatch.setattr(native_loader, "get_lib", fail)
    assert native_loader.native_available() is False
