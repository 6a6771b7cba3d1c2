"""Clipping by global norm and Adam over every leaf of a model at once: the
plain torch version and the wrapper of the hand-written CUDA kernels
``csrc/multi_tensor_adam.cu``.

The update is the optimizer's (``training.train_step.Optimizer``): optax's
``clip_by_global_norm`` on the whole gradient, then ``scale_by_adam``
(``adam_moments``) and each leaf's learning rate, with the moments and the
parameters updated in place. A leaf's moments may be views into one flat
vector (``flat_groups``): the arithmetic is elementwise, so either layout
gives the same bits.

``multi_tensor_clip_adam`` takes the plain version (``clip_adam_plain``,
about 20 torch operations a leaf) for CPU tensors and launches the kernels
for CUDA tensors: two launches for up to ``MAX_LEAVES`` leaves, two more for
each further ``MAX_LEAVES`` (``launches`` counts them, and the counter
``optimizer.fused_updates`` of ``utils.profiling`` the updates). A CUDA
tensor never falls back: the kernels launch or the wrapper raises. Where
the clip does not engage the kernels give the plain version's bits; where
it does, the norm is summed in another order than the plain version's sum
of per-leaf sums (in a fixed order: two calls give the same bits).

The kernels' leaf table (``plan``): the leaves in batches of up to
``MAX_LEAVES``, each leaf cut into ``CHUNK``-element chunks numbered leaf
after leaf; the table's addresses, sizes and rates are rebuilt whenever a
parameter's or a moment's address or a rate changes (a resumed state
replaces the moments), and only the gradients' addresses are read anew on
every call.
"""

from __future__ import annotations

import ctypes
import itertools
from functools import lru_cache

import numpy as np
import torch

from ..utils.profiling import count, span
from .fused_samplers import launch_checked

# optax.adam's defaults.
ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-8
# The kernels' constants (csrc/multi_tensor_adam.cu; the wrapper refuses a
# library built with others): elements a chunk, leaves a table, partial
# sums a table's norm pass writes.
CHUNK = 4096
MAX_LEAVES = 700
NORM_BLOCKS = 512
_MAX_LEAF = 2**31 - 1


def adam_moments(g: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor, corrections: tuple) -> tuple:
    """optax.scale_by_adam on one leaf: the new moments from the gradient
    ``g`` and the old ones, and the normalized update (before the learning
    rate). ``corrections``: ``bias_corrections`` of the update's count."""
    bc1, bc2 = corrections
    mu = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
    nu = (1.0 - ADAM_B2) * (g * g) + ADAM_B2 * nu
    return mu, nu, (mu / bc1) / (torch.sqrt(nu / bc2) + ADAM_EPS)


def clip_adam_plain(grads: list, params: list, mu: list, nu: list, neg_lrs: list, max_norm: float,
                    corrections: tuple) -> None:
    """The update in plain torch: the global norm as the sum of each leaf's
    ``torch.sum(g * g)``; optax's rule, ``g`` if ``norm < max_norm`` else
    ``(g / norm) * max_norm``; then ``adam_moments`` and ``p += update *
    neg_lr`` per leaf. Writes the moments and the parameters in place."""
    with span("taa.optimizer.clip"):
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < max_norm
        grads = [torch.where(keep, g, (g / norm) * max_norm) for g in grads]
    with span("taa.optimizer.adam"):
        for g, p, m, v, neg_lr in zip(grads, params, mu, nu, neg_lrs):
            new_m, new_v, update = adam_moments(g, m, v, corrections)
            m.copy_(new_m)
            v.copy_(new_v)
            p.add_(update * neg_lr)


def plan(sizes: list, max_leaves: int = MAX_LEAVES, chunk: int = CHUNK) -> list:
    """The kernels' tables for leaves of ``sizes`` elements: ``(first leaf,
    leaf count, first_chunk)`` for each batch of up to ``max_leaves``
    leaves, ``first_chunk`` [count + 1] int32 the batch's first chunk of
    each leaf (chunk c of a leaf covers its elements c * chunk .. (c + 1) *
    chunk - 1) and the batch's chunk count last."""
    tables = []
    for first in range(0, len(sizes), max_leaves):
        part = np.asarray(sizes[first:first + max_leaves], dtype=np.int64)
        first_chunk = np.zeros(len(part) + 1, dtype=np.int64)
        np.cumsum((part + chunk - 1) // chunk, out=first_chunk[1:])
        tables.append((first, len(part), first_chunk.astype(np.int32)))
    return tables


@lru_cache(maxsize=None)
def _kernels():
    """The C entry points of csrc/multi_tensor_adam.cu, built on first use."""
    from ..cuda_build import load

    lib = load("multi_tensor_adam")
    limits = lib.multi_tensor_adam_limits
    limits.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
    limits.restype = None
    got = [ctypes.c_int() for _ in range(3)]
    limits(*got)
    if [v.value for v in got] != [CHUNK, MAX_LEAVES, NORM_BLOCKS]:
        raise RuntimeError(f"csrc/multi_tensor_adam.cu was built with (chunk, leaves, norm blocks) "
                           f"{[v.value for v in got]}, the wrapper plans with {[CHUNK, MAX_LEAVES, NORM_BLOCKS]}")
    norm = lib.multi_tensor_norm
    norm.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    norm.restype = ctypes.c_int
    apply = lib.multi_tensor_clip_adam
    apply.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                                              ctypes.c_void_p]
    apply.restype = ctypes.c_int
    return norm, apply


def _check(tensors, sizes, device: int, what: str) -> None:
    for t, n in zip(tensors, sizes):
        if t.dtype is not torch.float32 or t.get_device() != device or not t.is_contiguous() or t.numel() != n:
            raise ValueError(f"the multi-tensor Adam kernels take contiguous float32 {what} of the parameters' "
                             f"sizes on cuda:{device}, not {t.dtype} {tuple(t.shape)} on {t.device} "
                             f"(contiguous: {t.is_contiguous()})")


class _Tables:
    """The kernels' host tables for one set of parameters and moments:
    ``ptrs`` [4, L] uint64 (gradients' row filled on each call), sizes,
    negated rates, and ``plan``'s batches."""

    def __init__(self, static: list, params: list, mu: list, nu: list, neg_lrs: list, device: int):
        sizes = [p.numel() for p in params]
        if max(sizes) > _MAX_LEAF:
            raise ValueError(f"the multi-tensor Adam kernels take leaves of up to {_MAX_LEAF} elements")
        for what, tensors in (("parameters", params), ("first moments", mu), ("second moments", nu)):
            _check(tensors, sizes, device, what)
        self.static, self.neg_lrs = static, list(neg_lrs)
        self.sizes = sizes
        self.batches = []
        for first, n, first_chunk in plan(sizes):
            ptrs = np.zeros((4, n), dtype=np.uint64)
            ptrs[1:] = np.asarray(static, dtype=np.uint64).reshape(3, -1)[:, first:first + n]
            self.batches.append((first, n, ptrs, np.asarray(sizes[first:first + n], dtype=np.int32), first_chunk,
                                 np.asarray(neg_lrs[first:first + n], dtype=np.float32)))
        # a norm launch a table, an update launch a table that has elements
        self.launches = len(self.batches) + sum(int(b[4][-1] > 0) for b in self.batches)


_tables: dict = {}  # device index -> the last _Tables built on it


def multi_tensor_clip_adam(grads: list, params: list, mu: list, nu: list, neg_lrs: list, max_norm: float,
                           corrections: tuple) -> None:
    """Clip the gradients ``grads`` by their global norm and apply Adam to
    ``params`` in place, leaf i at the rate ``-neg_lrs[i]``, with its moments
    ``mu[i]`` and ``nu[i]`` (updated in place; each of the parameter's
    size). ``corrections``: ``bias_corrections`` of the update's count.
    CPU tensors take ``clip_adam_plain``; CUDA tensors launch the kernels
    (every tensor contiguous fp32 on one card, or it raises); any other
    device raises."""
    if not grads or not len(grads) == len(params) == len(mu) == len(nu) == len(neg_lrs):
        raise ValueError("multi_tensor_clip_adam takes one gradient, parameter, moment pair and rate a leaf")
    kind = grads[0].device.type
    if kind == "cpu":
        return clip_adam_plain(grads, params, mu, nu, neg_lrs, max_norm, corrections)
    if kind != "cuda":
        raise ValueError(f"multi_tensor_clip_adam runs on cpu or cuda tensors, not {grads[0].device}")
    device = grads[0].get_device()
    static = [t.data_ptr() for t in itertools.chain(params, mu, nu)]
    tables = _tables.get(device)
    if tables is None or tables.static != static or tables.neg_lrs != list(neg_lrs):
        tables = _tables[device] = _Tables(static, params, mu, nu, neg_lrs, device)
    _check(grads, tables.sizes, device, "gradients")
    norm, apply = _kernels()
    bc1, bc2 = (np.float32(c) for c in corrections)
    one = np.float32(1.0)
    scalars = np.array([max_norm, 1.0 - ADAM_B1, ADAM_B1, 1.0 - ADAM_B2, ADAM_B2, one / bc1, one / bc2, ADAM_EPS],
                       dtype=np.float32)
    batches = tables.batches
    partials = torch.empty(NORM_BLOCKS * len(batches), dtype=torch.float32, device=grads[0].device)
    for first, n, ptrs, *_ in batches:
        ptrs[0] = [g.data_ptr() for g in grads[first:first + n]]

    def norm_pass(stream):
        for b, (_, n, ptrs, sizes, first_chunk, _) in enumerate(batches):
            err = norm(ptrs.ctypes.data, sizes.ctypes.data, first_chunk.ctypes.data, n,
                       partials.data_ptr() + 4 * NORM_BLOCKS * b, stream)
            if err:
                return err
        return 0

    def update_pass(stream):
        for _, n, ptrs, sizes, first_chunk, lrs in batches:
            err = apply(ptrs.ctypes.data, sizes.ctypes.data, first_chunk.ctypes.data, lrs.ctypes.data, n,
                        partials.data_ptr(), partials.numel(), scalars.ctypes.data, stream)
            if err:
                return err
        return 0

    with span("taa.optimizer.clip"):
        launch_checked(norm_pass, grads[0].device, "multi_tensor_norm")
    with span("taa.optimizer.adam"):
        launch_checked(update_pass, grads[0].device, "multi_tensor_clip_adam")
    multi_tensor_clip_adam.launches += tables.launches
    count("optimizer.fused_updates")


multi_tensor_clip_adam.launches = 0
