"""Flax parameter tree -> the port's ``state_dict``.

Takes the JAX package's parameters as nested dicts of numpy arrays (with or
without the outer ``{"params": ...}``) and returns a ``state_dict`` for an
``AudioAutoencoder`` of the same geometry. A flax path maps to the torch
name by joining it with dots and renaming the leaf:

- Dense ``kernel`` [in, out]       -> ``weight`` [out, in]
- Conv ``kernel`` [k, in/g, out]   -> ``weight`` [out, in/g, k]
- LayerNorm/GroupNorm ``scale``    -> ``weight``; ``bias`` stays ``bias``
- the SCCN's raw [c, c] / [c, 1] / [c] weights, the embedding tables and
  the scalars keep their names and layouts.

It raises on a leaf it does not consume, on a port parameter it does not
fill, and on any shape that does not match the port's.
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
