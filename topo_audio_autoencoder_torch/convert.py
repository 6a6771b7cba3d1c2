"""Flax parameter tree -> the port's ``state_dict``.

Takes the JAX package's parameters as nested dicts of numpy arrays (with or
without the outer ``{"params": ...}``) and returns a ``state_dict`` for an
``AudioAutoencoder`` of the same geometry. A flax path maps to the torch
name by joining it with dots and renaming the leaf:

- Dense ``kernel`` [in, out]       -> ``weight`` [out, in]
- Conv ``kernel`` [k, in/g, out]   -> ``weight`` [out, in/g, k]
- LayerNorm/GroupNorm ``scale``    -> ``weight``; ``bias`` stays ``bias``
- the SCCN's raw [c, c] / [c, 1] / [c] weights, the embedding tables and
  the scalars keep their names and layouts; under ``max_rank`` truncation
  the empty ranks' tables are [0, C] leaves on both sides.
- the jumping-knowledge LSTM cells (``decoder/sccn/OptimizedLSTMCell_{0,1}``)
  are Denses too: the input kernels ``ii/if/ig/io`` and the hidden kernels
  and biases ``hi/hf/hg/ho`` map onto the port cell's ``nn.Linear`` of the
  same name (``models.sccn.LSTMCell``).

It raises on a leaf it does not consume, on a port parameter it does not
fill, and on any shape that does not match the port's.

``opt_state_from_optax`` carries the optimizer across: a host copy of the
JAX package's optax state (``jax.device_get`` of ``TrainState.opt_state``)
becomes the port's ``OptState``, its moments renamed and laid out as the
parameters are. It reads the state by attribute names alone and imports
nothing of optax.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: tuple = ()) -> dict:
    flat = {}
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def _torch_leaf(path: tuple, value: np.ndarray) -> tuple[str, np.ndarray]:
    *modules, leaf = path
    if leaf == "kernel":
        if value.ndim == 2:  # Dense
            return ".".join((*modules, "weight")), value.T
        if value.ndim == 3:  # Conv
            return ".".join((*modules, "weight")), value.transpose(2, 1, 0)
        raise ValueError(f"{'/'.join(path)}: kernel of rank {value.ndim}")
    if leaf == "scale":
        return ".".join((*modules, "weight")), value
    return ".".join(path), value


def state_dict_from_flax(flax_params: Mapping, template: Mapping) -> dict:
    """Convert ``flax_params`` to a ``state_dict`` shaped like ``template``
    (the port model's own ``state_dict()``)."""
    if set(flax_params) == {"params"}:
        flax_params = flax_params["params"]
    out = {}
    for path, value in _flatten(flax_params).items():
        name, array = _torch_leaf(path, value)
        if name not in template:
            raise KeyError(f"flax leaf {'/'.join(path)} -> {name}: no such port parameter")
        target = template[name]
        if tuple(array.shape) != tuple(target.shape):
            raise ValueError(
                f"flax leaf {'/'.join(path)} -> {name}: shape {tuple(array.shape)} "
                f"does not match the port's {tuple(target.shape)}"
            )
        # A copy: the result shares no memory with the flax arrays, and a
        # scalar keeps its shape () (np.ascontiguousarray would make it 1-d).
        out[name] = torch.tensor(np.asarray(array), dtype=target.dtype)
    missing = sorted(set(template) - set(out))
    if missing:
        raise KeyError(f"port parameters not filled by the flax tree: {missing}")
    return out


def _find(tree, attribute: str):
    """The first object in ``tree`` (tuples, lists, dicts and named tuples,
    depth first) that has ``attribute``."""
    if hasattr(tree, attribute):
        return tree
    children = tree.values() if isinstance(tree, Mapping) else tree if isinstance(tree, (tuple, list)) else ()
    for child in children:
        found = _find(child, attribute)
        if found is not None:
            return found
    return None


def _flatten_unmasked(tree: Mapping, prefix: tuple = ()) -> dict:
    """``_flatten`` without optax's masked entries (the other group's
    leaves, which carry no array)."""
    flat = {}
    for key, value in tree.items():
        path = (*prefix, str(key))
        if isinstance(value, Mapping):
            flat.update(_flatten_unmasked(value, path))
        elif hasattr(value, "shape"):
            flat[path] = np.asarray(value)
    return flat


def opt_state_from_optax(opt_state, template: Mapping):
    """Convert the JAX package's optax state to the port's ``OptState``.

    ``opt_state`` is ``make_optimizer``'s state on the host: ``clip ->
    multi_transform({encoder: adam, decoder: adam})``, wrapped in
    ``MultiSteps`` when gradients accumulate. Each group's Adam moments
    ``mu``/``nu`` cover its own leaves (an encoder parameter from the
    ``encoder`` group, every other one from ``decoder``; the other group's
    entries are masked); ``count`` is the number of applied updates, equal
    in both groups. Under ``MultiSteps`` its ``mini_step`` and, mid-cycle,
    ``acc_grads`` become the port's ``mini_step`` and ``acc``. A state of
    ``make_optimizer(flat_groups=True)`` holds each group's moments as one
    vector raveled over the group's leaves in flax's order, the port's flat
    order too (``train_step.flax_order``), each leaf in flax's layout: the
    converter reorders the elements of every Dense and Conv kernel into the
    port's layout, for an ``OptState`` of ``make_optimizer(flat_groups=True)``.

    ``template`` is the port model's ``state_dict()``: the moments take its
    names, shapes, dtypes and device. Raises where a leaf cannot be placed
    (a foreign name, a leaf in the wrong group, a wrong shape) or a
    parameter is left without moments.
    """
    from .training.train_step import GROUPS, OptState, flax_order, group_of

    def tensor(name, path, value):
        if name not in template:
            raise KeyError(f"optax leaf {'/'.join(path)} -> {name}: no such port parameter")
        target = template[name]
        if tuple(value.shape) != tuple(target.shape):
            raise ValueError(
                f"optax leaf {'/'.join(path)} -> {name}: shape {tuple(value.shape)} "
                f"does not match the port's {tuple(target.shape)}"
            )
        return torch.tensor(np.asarray(value), dtype=target.dtype, device=target.device)

    def convert(tree, group=None) -> dict:
        if set(tree) == {"params"}:
            tree = tree["params"]
        out = {}
        for path, value in _flatten_unmasked(tree).items():
            name, array = _torch_leaf(path, value)
            if group is not None and group_of(name) != group:
                raise ValueError(f"optax leaf {'/'.join(path)} -> {name} is in the {group} group")
            out[name] = tensor(name, path, array)
        return out

    def flat_vector(group, value):
        """optax.flatten's vector (flax's leaves, each in flax's layout) ->
        the port's (the same leaves, each in the port's layout)."""
        names = [n for n in flax_order(template) if group_of(n) == group]
        sizes = [template[n].numel() for n in names]
        value = np.asarray(value)
        if value.shape != (sum(sizes),):
            raise ValueError(f"optax group {group!r}: a flat moment of shape {value.shape}, "
                             f"the group's {len(names)} parameters hold {sum(sizes)}")
        parts = []
        for name, part in zip(names, np.split(value, np.cumsum(sizes)[:-1])):
            shape = tuple(template[name].shape)
            if name.endswith(".weight") and len(shape) >= 2:  # a kernel: flax's layout is the port's reversed
                part = part.reshape(shape[::-1]).transpose()
            parts.append(part.reshape(-1))
        first = template[names[0]]
        return torch.tensor(np.concatenate(parts), dtype=first.dtype, device=first.device)

    partition = _find(opt_state, "inner_states")
    if partition is None:
        raise ValueError("no multi_transform state (inner_states) in the optax state")
    mu, nu, counts, layouts = {}, {}, set(), set()
    for group, masked in partition.inner_states.items():
        if group not in GROUPS:
            raise KeyError(f"optax group {group!r}: the port has only 'encoder' and 'decoder'")
        adam = _find(getattr(masked, "inner_state", masked), "nu")
        if adam is None or not hasattr(adam, "mu") or not hasattr(adam, "count"):
            raise ValueError(f"optax group {group!r} holds no Adam state (mu, nu, count)")
        flat = hasattr(adam.mu, "shape")  # optax.flatten: one raveled vector a group
        layouts.add(flat)
        for into, moments in ((mu, adam.mu), (nu, adam.nu)):
            if flat:
                into[group] = flat_vector(group, moments)
                continue
            converted = convert(moments, group)
            clash = set(into) & set(converted)
            if clash:
                raise ValueError(f"optax leaves in two groups: {sorted(clash)}")
            into.update(converted)
        counts.add(int(np.asarray(adam.count)))
    if len(layouts) != 1:
        raise ValueError("one optax group is flattened (flat_groups) and the other is not")
    for what, moments in (("mu", mu), ("nu", nu)):
        missing = sorted(set(GROUPS) - set(moments) if layouts == {True} else set(template) - set(moments))
        if missing:
            raise KeyError(f"port parameters without an optax {what}: {missing}")
    if len(counts) != 1:
        raise ValueError(f"the groups' Adam counts differ: {sorted(counts)}")
    mini_step, acc = 0, {}
    if hasattr(opt_state, "mini_step") and hasattr(opt_state, "acc_grads"):
        mini_step = int(np.asarray(opt_state.mini_step))
        if mini_step:
            acc = convert(opt_state.acc_grads)
            missing = sorted(set(template) - set(acc))
            if missing:
                raise KeyError(f"port parameters without an optax acc_grads leaf: {missing}")
    return OptState(mu=mu, nu=nu, count=counts.pop(), mini_step=mini_step, acc=acc)
